// Paged-attention decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/paged_attention.py:
//   paged_attention_launch <- _paged_attn_kernel (paged_attention)
// One query token per request attends over the request's blocks of a
// shared KV pool, named by the request's row of the block table:
//   q (B, h, hd); k_pool, v_pool (P, bs, kh, hd); pos_pool (P, bs) int32
//   (-1 = never written); table (B, mb) int32; qpos (B,) int32;
//   out (B, h, hd) in q's type.  q, the pools and out are fp32 or bf16.
// Position p of pool block table[i, j] is attendable iff
//   0 <= p <= qpos[i]   (and qpos[i] - p < window when window > 0);
// scores are (q . k) * scale, then softcap * tanh(s / softcap) when
// softcap > 0, and NEG_INF where not attendable; a running (m, l, acc)
// softmax walks the request's blocks, with p = 0 where the score is
// NEG_INF and l clamped at 1e-30 in the final division: the arithmetic of
// paged_attention.py:56-84.
//
// The TPU kernel walks a request's blocks in a sequential grid dimension
// and carries (m, l, acc) in VMEM.  GPU blocks run in no order, so one CUDA
// block owns one (request, kv head): it loads its own row of the table and
// its qpos (what the TPU kernel's scalar prefetch supplies) and loops over
// the mb table entries itself, with the running (m, l, acc) of the
// g = h / kh query heads of its kv head in shared memory.
//
// What bounds it on an H100: latency, not bytes.  At gemma-2b decode
// (B = 4, kh = 1, hd = 256, 160 positions) K, V and pos of one layer are
// about 1.3 MB, 0.4 us at 3.35 TB/s, but only B * kh = 4 blocks run on 132
// SMs, each walking its blocks one after another.  The next design splits
// the table's columns over blocks and combines their partial (m, l, acc)
// in a fixed-order second pass.
//
// Idle engine slots point every table entry at the null block 0; the
// kernel reads it like any other block (their outputs are discarded).  A
// table entry outside [0, P) stops the kernel with a device-side trap (as
// PyTorch's own index kernels assert on the device), so checking the table
// costs no host synchronisation.  hd, bs and g need no particular
// multiple: the loops mask the ragged edges.
// fp32 FMA throughout, full-precision expf and tanhf (no fast math).
// Plain C interface, bound with ctypes (kernels/build.py,
// kernels/paged_attention.py); launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdio>

#include "loaders.cuh"

namespace {

using repro_kernels::to_f;

constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Shared memory: qs and acc (g * hd each), the block's scores, then its
// probabilities (g * bs), and m, l, corr (g each).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int* __restrict__ pos_pool,
                  const int* __restrict__ table, const int* __restrict__ qpos,
                  T* __restrict__ out, int npool, int h, int kh, int hd,
                  int bs, int mb, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  const int g = h / kh;
  const int i = blockIdx.x, kv = blockIdx.y;
  float* qs = smem;
  float* acc = qs + g * hd;
  float* sc = acc + g * hd;
  float* m = sc + g * bs;
  float* l = m + g;
  float* corr = l + g;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int qp = qpos[i];
  // query heads kv * g .. kv * g + g - 1 are contiguous in q and out
  const size_t head0 = (static_cast<size_t>(i) * h + kv * g) * hd;
  for (int e = tid; e < g * hd; e += kThreads) {
    qs[e] = to_f(q[head0 + e]);
    acc[e] = 0.f;
  }
  for (int e = tid; e < g; e += kThreads) {
    m[e] = kNegInf;
    l[e] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < mb; ++j) {
    const int entry = table[static_cast<size_t>(i) * mb + j];
    if (entry < 0 || entry >= npool) {  // uniform across the block
      if (threadIdx.x == 0)
        printf("paged_attention: table[%d, %d] = %d outside the pool of %d "
               "blocks\n", i, j, entry, npool);
      __trap();
    }
    const size_t blk = entry;
    // scores: one warp per (query head, position); lanes stride over hd
    for (int e = warp; e < g * bs; e += kWarps) {
      const int gi = e / bs, t = e % bs;
      const T* kr = k_pool + ((blk * bs + t) * kh + kv) * hd;
      const float* qr = qs + gi * hd;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot = fmaf(qr[d], to_f(kr[d]), dot);
      dot = warp_sum(dot);
      if (lane == 0) {
        float s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int p = pos_pool[blk * bs + t];
        bool valid = p >= 0 && p <= qp;
        if (window > 0) valid = valid && qp - p < window;
        sc[e] = valid ? s : kNegInf;
      }
    }
    __syncthreads();
    // running softmax: one warp per query head
    for (int gi = warp; gi < g; gi += kWarps) {
      float* row = sc + gi * bs;
      float mx = kNegInf;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, row[t]);
      const float m_prev = m[gi];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float s = row[t];
        const float p = s <= kNegInf / 2 ? 0.f : expf(s - m_new);
        row[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[gi] = c;
        l[gi] = l[gi] * c + sum;
        m[gi] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + p V: one thread per (query head, dim), so the V
    // reads of neighbouring threads are neighbouring addresses
    for (int e = tid; e < g * hd; e += kThreads) {
      const int gi = e / hd, d = e % hd;
      const float* pr = sc + gi * bs;
      const T* vc = v_pool + (blk * bs * kh + kv) * hd + d;
      float pv = 0.f;
      for (int t = 0; t < bs; ++t)
        pv = fmaf(pr[t], to_f(vc[static_cast<size_t>(t) * kh * hd]), pv);
      acc[e] = acc[e] * corr[gi] + pv;
    }
    __syncthreads();
  }

  for (int e = tid; e < g * hd; e += kThreads)
    out[head0 + e] = from_f<T>(acc[e] / fmaxf(l[e / hd], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* pos_pool, const int* table, const int* qpos, void* out,
           int b, int npool, int h, int kh, int hd, int bs, int mb,
           int window, float softcap, float scale, cudaStream_t st) {
  const int g = h / kh;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(g) * hd +
                                       static_cast<size_t>(g) * bs + 3 * g);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paged_attn_kernel<T><<<dim3(b, kh), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), pos_pool, table, qpos,
      static_cast<T*>(out), npool, h, kh, hd, bs, mb, window, softcap,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k_pool, v_pool and out).
// window <= 0: no sliding window; softcap <= 0: no soft cap.
// npool: the pools' block count P (table entries must lie in [0, P)).
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const int* pos_pool,
                           const int* table, const int* qpos, void* out, int b,
                           int npool, int h, int kh, int hd, int bs, int mb,
                           int window, float softcap, float scale, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, pos_pool, table, qpos, out, b,
                         npool, h, kh, hd, bs, mb, window, softcap, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, pos_pool, table, qpos,
                                 out, b, npool, h, kh, hd, bs, mb, window,
                                 softcap, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
