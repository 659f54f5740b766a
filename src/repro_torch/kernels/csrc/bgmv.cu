// Multi-adapter BGMV kernels for banked LoRA serving, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/bgmv.py:
//   bgmv_matmul_launch        <- _bgmv_kernel        (bgmv_matmul, prefill)
//   bgmv_gemv_launch          <- _bgmv_gemv_kernel   (bgmv_gemv, decode)
//   bgmv_matmul_quant_launch  <- _bgmv_kernel_q      (bgmv_matmul_quant)
//   bgmv_gemv_quant_launch    <- _bgmv_gemv_kernel_q (bgmv_gemv_quant)
// All compute, for request row i served with tenant ids[i],
//   y[i] = x[i] W + (x[i] A[ids[i]]^T) B[ids[i]]^T
// with x (B, s, k) or (B, k), W (k, n), A (K, r, k), B (K, n, r); x, A and
// B fp32 or bf16 (all three the same type), W of that type too or packed
// int8 / int4 (core/quant.py's layout, dequantized element by element as
// the kernel loads it, rounded to bf16 for a base packed from bf16
// weights: loaders.cuh); fp32 FMA accumulation, fp32 output.
// ids == nullptr means the identity map (row i <-> adapter i).  The packed
// and the fp forms are one kernel body each, templated on the W loader.
//
// The TPU kernel carries p = x A^T in VMEM from the n == 0 sweep to later
// n-blocks; GPU blocks run in no order, so a pre-pass (shrink_kernel)
// writes p to an fp32 scratch (B*s, r) that the main kernels read.
//
// Ragged edges are masked in the kernels: no shape needs padding (a packed
// int4 W may hold kq > k rows; rows >= k are never read).
// Plain C interface, bound with ctypes (kernels/build.py, kernels/bgmv.py).
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "gemv.cuh"
#include "loaders.cuh"

namespace {

using repro_kernels::DenseW;
using repro_kernels::gemv_partial_kernel;
using repro_kernels::kGvCols;
using repro_kernels::kGvMaxB;
using repro_kernels::kGvWarps;
using repro_kernels::to_f;
using repro_kernels::with_packed_w;

// ------------------------------------------------------------- shrink
// p[row, j] = sum_k x[row, k] * A[id(row), j, k], one warp per (row, j):
// the warp's lanes stride over k (coalesced reads of the x row and the A
// row), then reduce with shuffles.  rows = B * s; request = row / s.
constexpr int kShrinkWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kShrinkWarps * 32)
shrink_kernel(const T* __restrict__ x, const T* __restrict__ a,
              const int* __restrict__ ids, float* __restrict__ p, int rows,
              int s, int k, int r) {
  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.y * kShrinkWarps + warp;
  if (row >= rows || j >= r) return;  // uniform across the warp
  const int req = row / s;
  const int id = ids ? ids[req] : req;
  const T* xr = x + static_cast<size_t>(row) * k;
  const T* ar = a + (static_cast<size_t>(id) * r + j) * k;
  float acc = 0.f;
  for (int kk = lane; kk < k; kk += 32) acc = fmaf(to_f(xr[kk]), to_f(ar[kk]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) p[static_cast<size_t>(row) * r + j] = acc;
}

// ------------------------------------------------------------- matmul
// Prefill form.  Rows of all requests are flattened to M = B * s, so one
// output tile reads its W tile once for every request in it.  Classic
// shared-memory tiling: 64 x 64 output tile, k in steps of 16, 256
// threads, 4 x 4 outputs per thread (rows ty + 16 i, cols tx + 16 j, so
// shared-memory reads are broadcasts or conflict-free).  The W tile comes
// through the loader WL (fp, or dequantized as it is loaded).  The
// epilogue adds p[row] . B[id(row), col] (rank r <= 512, read from L2).
constexpr int kMmBM = 64, kMmBN = 64, kMmBK = 16, kMmThreads = 256;

template <typename T, typename WL>
__global__ void __launch_bounds__(kMmThreads)
matmul_kernel(const T* __restrict__ x, const WL wl,
              const T* __restrict__ bm, const int* __restrict__ ids,
              const float* __restrict__ p, float* __restrict__ out, int m_rows,
              int s, int k, int n, int r) {
  __shared__ float xs[kMmBK][kMmBM];
  __shared__ float ws[kMmBK][kMmBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kMmBM, n0 = blockIdx.x * kMmBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kMmBK) {
#pragma unroll
    for (int t = 0; t < (kMmBM * kMmBK) / kMmThreads; ++t) {
      const int idx = tid + t * kMmThreads;
      const int mm = idx / kMmBK, kk = idx % kMmBK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < m_rows && gk < k)
                       ? to_f(x[static_cast<size_t>(gm) * k + gk]) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < (kMmBK * kMmBN) / kMmThreads; ++t) {
      const int idx = tid + t * kMmThreads;
      const int kk = idx / kMmBN, nn = idx % kMmBN;
      const int gk = k0 + kk, gn = n0 + nn;
      ws[kk][nn] = (gk < k && gn < n) ? wl(gk, gn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmBK; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m_rows) continue;
    const int req = gm / s;
    const int id = ids ? ids[req] : req;
    const float* pr = p + static_cast<size_t>(gm) * r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= n) continue;
      const T* br = bm + (static_cast<size_t>(id) * n + gn) * r;
      float lora = 0.f;
      for (int q = 0; q < r; ++q) lora = fmaf(pr[q], to_f(br[q]), lora);
      out[static_cast<size_t>(gm) * n + gn] = acc[i][j] + lora;
    }
  }
}

// --------------------------------------------------------------- gemv
// Decode form: the split-k partial sums of x W come from gemv.cuh's
// gemv_partial_kernel (shared with the packed GEMM's decode form), and
// finalize_kernel adds them in a fixed order (deterministic), then adds the
// rank-r term.
template <typename T>
__global__ void finalize_kernel(const float* __restrict__ partial,
                                const float* __restrict__ p,
                                const T* __restrict__ bm,
                                const int* __restrict__ ids,
                                float* __restrict__ out, int nb, int n, int r,
                                int ksplit) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nb * n) return;
  const int b = idx / n, col = idx % n;
  float acc = 0.f;
  for (int q = 0; q < ksplit; ++q)
    acc += partial[(static_cast<size_t>(q) * nb + b) * n + col];
  const int id = ids ? ids[b] : b;
  const float* pr = p + static_cast<size_t>(b) * r;
  const T* br = bm + (static_cast<size_t>(id) * n + col) * r;
  float lora = 0.f;
  for (int q = 0; q < r; ++q) lora = fmaf(pr[q], to_f(br[q]), lora);
  out[idx] = acc + lora;
}

template <typename T, typename WL>
int matmul_launch(const void* x, const WL wl, const void* a, const void* b,
                  const int* ids, float* p, float* out, int nreq, int s, int k,
                  int n, int r, cudaStream_t st) {
  const int rows = nreq * s;
  shrink_kernel<T><<<dim3(rows, (r + kShrinkWarps - 1) / kShrinkWarps),
                     kShrinkWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), ids, p, rows, s, k,
      r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  matmul_kernel<T, WL>
      <<<dim3((n + kMmBN - 1) / kMmBN, (rows + kMmBM - 1) / kMmBM), kMmThreads,
         0, st>>>(static_cast<const T*>(x), wl, static_cast<const T*>(b), ids,
                  p, out, rows, s, k, n, r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename WL>
int gemv_launch(const void* x, const WL wl, const void* a, const void* b,
                const int* ids, float* p, float* partial, float* out, int nreq,
                int k, int n, int r, int ksplit, int kchunk, cudaStream_t st) {
  shrink_kernel<T><<<dim3(nreq, (r + kShrinkWarps - 1) / kShrinkWarps),
                     kShrinkWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), ids, p, nreq, 1, k,
      r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gemv_partial_kernel<T, WL>
      <<<dim3((n + kGvCols - 1) / kGvCols, ksplit, (nreq + kGvMaxB - 1) / kGvMaxB),
         dim3(kGvCols, kGvWarps), 0, st>>>(static_cast<const T*>(x), wl,
                                           partial, nreq, k, n, kchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = nreq * n;
  finalize_kernel<T><<<(total + 255) / 256, 256, 0, st>>>(
      partial, p, static_cast<const T*>(b), ids, out, nreq, n, r, ksplit);
  return static_cast<int>(cudaGetLastError());
}

// The packed forms: the same launches with an int8 or int4 W loader.
template <typename T>
int matmul_quant(const void* x, const void* wd, const float* ws, const void* a,
                 const void* b, const int* ids, float* p, float* out, int nreq,
                 int s, int k, int n, int r, int bits, int group, int bf16w,
                 cudaStream_t st) {
  return with_packed_w(wd, ws, n, bits, group, bf16w, [&](auto wl) {
    return matmul_launch<T>(x, wl, a, b, ids, p, out, nreq, s, k, n, r, st);
  });
}

template <typename T>
int gemv_quant(const void* x, const void* wd, const float* ws, const void* a,
               const void* b, const int* ids, float* p, float* partial,
               float* out, int nreq, int k, int n, int r, int ksplit,
               int kchunk, int bits, int group, int bf16w, cudaStream_t st) {
  return with_packed_w(wd, ws, n, bits, group, bf16w, [&](auto wl) {
    return gemv_launch<T>(x, wl, a, b, ids, p, partial, out, nreq, k, n, r,
                          ksplit, kchunk, st);
  });
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w, a, b all of that type).
// p: (nreq * s, r) fp32 scratch; out: (nreq * s, n) fp32.
int bgmv_matmul_launch(const void* x, const void* w, const void* a,
                       const void* b, const int* ids, float* p, float* out,
                       int nreq, int s, int k, int n, int r, int dtype,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return matmul_launch<float>(
        x, DenseW<float>{static_cast<const float*>(w), n}, a, b, ids, p, out,
        nreq, s, k, n, r, st);
  if (dtype == 1)
    return matmul_launch<__nv_bfloat16>(
        x, DenseW<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(w), n}, a,
        b, ids, p, out, nreq, s, k, n, r, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// p: (nreq, r) fp32 scratch; partial: (ksplit, nreq, n) fp32 scratch;
// out: (nreq, n) fp32.  The k range splits into ksplit chunks of kchunk.
int bgmv_gemv_launch(const void* x, const void* w, const void* a,
                     const void* b, const int* ids, float* p, float* partial,
                     float* out, int nreq, int k, int n, int r, int ksplit,
                     int kchunk, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gemv_launch<float>(
        x, DenseW<float>{static_cast<const float*>(w), n}, a, b, ids, p,
        partial, out, nreq, k, n, r, ksplit, kchunk, st);
  if (dtype == 1)
    return gemv_launch<__nv_bfloat16>(
        x, DenseW<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(w), n}, a,
        b, ids, p, partial, out, nreq, k, n, r, ksplit, kchunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Packed W: wd int8 (k, n) with ws (1, n) when bits == 8; uint8 (kq/2, n)
// with ws (kq/group, n) when bits == 4; bf16w = 1 for a base packed from
// bf16 weights (each element rounded to bf16, loaders.cuh).  x, a, b of
// dtype as above.
int bgmv_matmul_quant_launch(const void* x, const void* wd, const float* ws,
                             const void* a, const void* b, const int* ids,
                             float* p, float* out, int nreq, int s, int k,
                             int n, int r, int bits, int group, int bf16w,
                             int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return matmul_quant<float>(x, wd, ws, a, b, ids, p, out, nreq, s, k, n, r,
                               bits, group, bf16w, st);
  if (dtype == 1)
    return matmul_quant<__nv_bfloat16>(x, wd, ws, a, b, ids, p, out, nreq, s,
                                       k, n, r, bits, group, bf16w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int bgmv_gemv_quant_launch(const void* x, const void* wd, const float* ws,
                           const void* a, const void* b, const int* ids,
                           float* p, float* partial, float* out, int nreq,
                           int k, int n, int r, int ksplit, int kchunk,
                           int bits, int group, int bf16w, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gemv_quant<float>(x, wd, ws, a, b, ids, p, partial, out, nreq, k, n,
                             r, ksplit, kchunk, bits, group, bf16w, st);
  if (dtype == 1)
    return gemv_quant<__nv_bfloat16>(x, wd, ws, a, b, ids, p, partial, out,
                                     nreq, k, n, r, ksplit, kchunk, bits,
                                     group, bf16w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
