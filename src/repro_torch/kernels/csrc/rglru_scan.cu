// RG-LRU diagonal linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rglru_scan.py:
//   rglru_scan_launch <- _kernel (rglru_scan_pallas)
// computing, over the sequence axis of a, b (bt, s, d) in fp32 or bf16,
//   h_0 = 0,  h_t = a_t * h_{t-1} + b_t,  out[:, t] = h_t in a's type.
// The carry h stays fp32 for the whole sequence; only the stored h_t is
// rounded to the output type, as _kernel and rglru_scan_ref do.  Each step
// is one rounded product and one rounded sum (__fmul_rn, __fadd_rn: no
// contraction into an FMA), the arithmetic of the plain version
// (kernels/rglru_scan.py: a * h + b, two elementwise ops), so the kernel
// equals it bit for bit.
//
// The TPU kernel walks sequence blocks in a sequential grid dimension and
// carries h across them in VMEM scratch.  GPU blocks run in no order, so
// here one thread owns one (batch row, channel) column and walks the whole
// sequence itself: the carry never leaves its register.  Neighbouring
// threads own neighbouring channels, so every load and store of a step is
// coalesced across d.
//
// What bounds it on an H100: bytes (one read of a and b, one write of h:
// 25.2 MB at the RG-LRU prefill's (4, 128, 4096) fp32, 7.5 us at 3.35
// TB/s) -- but only if enough loads are in flight.  Each step depends on the
// one before, so the thread prefetches the next kUnroll steps' a and b into
// registers before it runs the current kUnroll steps' dependent chain.
// With bt * d = 16384 threads the card is under-filled (and at
// (4, 2048, 256) only 1024 threads run 2048 steps each); a chunked
// two-pass scan (per-chunk carries, then a fix-up pass) is the next design.
//
// Plain C interface, bound with ctypes (kernels/build.py,
// kernels/rglru_scan.py); launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "loaders.cuh"

namespace {

using repro_kernels::to_f;

constexpr int kThreads = 64, kUnroll = 8;

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ h, int s, int d) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * d + col;
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h + base;
  float an[kUnroll], bn[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool ok = u < s;
    an[u] = ok ? to_f(__ldg(ap + static_cast<size_t>(u) * d)) : 0.f;
    bn[u] = ok ? to_f(__ldg(bp + static_cast<size_t>(u) * d)) : 0.f;
  }
  float carry = 0.f;
  for (int t0 = 0; t0 < s; t0 += kUnroll) {
    float ac[kUnroll], bc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ac[u] = an[u];
      bc[u] = bn[u];
      const int t = t0 + kUnroll + u;
      const bool ok = t < s;
      an[u] = ok ? to_f(__ldg(ap + static_cast<size_t>(t) * d)) : 0.f;
      bn[u] = ok ? to_f(__ldg(bp + static_cast<size_t>(t) * d)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < s) {
        carry = __fadd_rn(__fmul_rn(ac[u], carry), bc[u]);
        hp[static_cast<size_t>(t) * d] = from_f<T>(carry);
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* h, int bt, int s, int d,
           cudaStream_t st) {
  const dim3 grid((d + kThreads - 1) / kThreads, bt);
  rglru_scan_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(h), s, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and h).  bt <= 65535.
int rglru_scan_launch(const void* a, const void* b, void* h, int bt, int s,
                      int d, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h, bt, s, d, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h, bt, s, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
