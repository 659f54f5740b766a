// RG-LRU diagonal linear recurrence for Hopper (sm_90a): the scan and its
// backward.
//
// rglru_scan_launch replaces the Pallas TPU kernel of
// src/repro/kernels/rglru_scan.py (_kernel, rglru_scan_pallas), computing,
// over the sequence axis of a, b (bt, s, d) in fp32 or bf16,
//   h_0 = 0,  h_t = a_t * h_{t-1} + b_t,  out[:, t] = h_t in a's type.
// The carry h stays fp32 for the whole sequence; only the stored h_t is
// rounded to the output type, as _kernel and rglru_scan_ref do.  Each step
// is one rounded product and one rounded sum (__fmul_rn, __fadd_rn: no
// contraction into an FMA), the arithmetic of the plain version
// (kernels/rglru_scan.py: a * h + b, two elementwise ops), so the kernel
// equals it bit for bit.
//
// rglru_scan_bwd_launch replaces no Pallas body: the JAX package trains
// through the scan by differentiating jax.lax.associative_scan
// (src/repro/models/rglru.py:rglru_scan).  For a, the forward's output h
// and the cotangent g = dL/dh, all (bt, s, d) in a's type, it computes
//   dh_{s-1} = g_{s-1},  dh_t = g_t + a_{t+1} * dh_{t+1},
//   da_t = dh_t * h_{t-1} (h_{-1} = 0),  db_t = dh_t,
// the carry dh in fp32, da and db stored in a's type; each step again one
// rounded product and one rounded sum, and da_t one rounded product, so it
// equals the plain reverse loop (rglru_scan_bwd_plain) bit for bit.
//
// The TPU kernel walks sequence blocks in a sequential grid dimension and
// carries h across them in VMEM scratch.  GPU blocks run in no order, so
// here one thread owns one (batch row, channel) column and walks the whole
// sequence itself (forwards, or backwards for the gradient): the carry
// never leaves its register.  Neighbouring threads own neighbouring
// channels, so every load and store of a step is coalesced across d.
//
// What bounds them on an H100: bytes -- the forward reads a and b and
// writes h (25.2 MB at the RG-LRU prefill's (4, 128, 4096) fp32, 7.5 us at
// 3.35 TB/s); the backward reads a, h and g and writes da and db (41.9 MB
// there, 12.5 us) -- but only if enough loads are in flight.  Each step
// depends on the one before, so the thread prefetches the next kUnroll
// steps' operands into registers before it runs the current kUnroll
// steps' dependent chain.  With bt * d = 16384 threads the card is
// under-filled (and at (4, 2048, 256) only 1024 threads run 2048 steps
// each); a chunked two-pass scan (per-chunk carries, then a fix-up pass),
// in both directions, is the next design.
//
// Plain C interface, bound with ctypes (kernels/build.py,
// kernels/rglru_scan.py); launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "loaders.cuh"

namespace {

using repro_kernels::ldg;
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
    an[u] = ok ? to_f(ldg(ap + static_cast<size_t>(u) * d)) : 0.f;
    bn[u] = ok ? to_f(ldg(bp + static_cast<size_t>(u) * d)) : 0.f;
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
      an[u] = ok ? to_f(ldg(ap + static_cast<size_t>(t) * d)) : 0.f;
      bn[u] = ok ? to_f(ldg(bp + static_cast<size_t>(t) * d)) : 0.f;
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

// The operands of backward step t: g_t, a_t (the factor of step t - 1)
// and h_{t-1} (0 at t = 0); zeros for t < 0, past the sequence's start.
template <typename T>
__device__ __forceinline__ void fetch_bwd(const T* ap, const T* hp,
                                          const T* gp, int t, int d,
                                          float& av, float& hv, float& gv) {
  const bool ok = t >= 0;
  const size_t o = static_cast<size_t>(ok ? t : 0) * d;
  gv = ok ? to_f(ldg(gp + o)) : 0.f;
  av = ok ? to_f(ldg(ap + o)) : 0.f;
  hv = (ok && t > 0) ? to_f(ldg(hp + o - d)) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                      const T* __restrict__ g, T* __restrict__ da,
                      T* __restrict__ db, int s, int d) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * d + col;
  const T* ap = a + base;
  const T* hp = h + base;
  const T* gp = g + base;
  T* dap = da + base;
  T* dbp = db + base;
  float an[kUnroll], hn[kUnroll], gn[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    fetch_bwd(ap, hp, gp, s - 1 - u, d, an[u], hn[u], gn[u]);
  // dh carries dh_{t+1}, a_next a_{t+1}; both 0 past the sequence's end
  float dh = 0.f, a_next = 0.f;
  for (int t0 = s - 1; t0 >= 0; t0 -= kUnroll) {
    float ac[kUnroll], hc[kUnroll], gc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ac[u] = an[u];
      hc[u] = hn[u];
      gc[u] = gn[u];
      fetch_bwd(ap, hp, gp, t0 - kUnroll - u, d, an[u], hn[u], gn[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        dh = __fadd_rn(gc[u], __fmul_rn(a_next, dh));
        a_next = ac[u];
        const size_t o = static_cast<size_t>(t) * d;
        dap[o] = from_f<T>(__fmul_rn(dh, hc[u]));
        dbp[o] = from_f<T>(dh);
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

template <typename T>
int launch_bwd(const void* a, const void* h, const void* g, void* da,
               void* db, int bt, int s, int d, cudaStream_t st) {
  const dim3 grid((d + kThreads - 1) / kThreads, bt);
  rglru_scan_bwd_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(g), static_cast<T*>(da), static_cast<T*>(db), s,
      d);
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

// dtype: 0 = float32, 1 = bfloat16 (a, h, g, da and db).  bt <= 65535.
int rglru_scan_bwd_launch(const void* a, const void* h, const void* g,
                          void* da, void* db, int bt, int s, int d, int dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(a, h, g, da, db, bt, s, d, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(a, h, g, da, db, bt, s, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
