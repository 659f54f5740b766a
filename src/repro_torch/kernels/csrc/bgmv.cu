// Multi-adapter BGMV kernels for banked LoRA serving, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/bgmv.py:
//   bgmv_matmul_launch  <- _bgmv_kernel      (bgmv_matmul, prefill)
//   bgmv_gemv_launch    <- _bgmv_gemv_kernel (bgmv_gemv, decode)
// Both compute, for request row i served with tenant ids[i],
//   y[i] = x[i] W + (x[i] A[ids[i]]^T) B[ids[i]]^T
// with x (B, s, k) or (B, k), W (k, n), A (K, r, k), B (K, n, r); inputs
// fp32 or bf16 (all four the same type), fp32 FMA accumulation, fp32
// output.  ids == nullptr means the identity map (row i <-> adapter i).
//
// The TPU kernel carries p = x A^T in VMEM from the n == 0 sweep to later
// n-blocks; GPU blocks run in no order, so a pre-pass (shrink_kernel)
// writes p to an fp32 scratch (B*s, r) that the main kernels read.
//
// Ragged edges are masked in the kernels: no shape needs padding.
// Plain C interface, bound with ctypes (kernels/build.py, kernels/bgmv.py).
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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
// shared-memory reads are broadcasts or conflict-free).  The epilogue adds
// p[row] . B[id(row), col] (rank r <= 512, read from L2).
constexpr int kMmBM = 64, kMmBN = 64, kMmBK = 16, kMmThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kMmThreads)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
      ws[kk][nn] = (gk < k && gn < n)
                       ? to_f(w[static_cast<size_t>(gk) * n + gn]) : 0.f;
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
// Decode form, bound by reading W.  A block owns 32 columns (lane = column,
// so each warp reads 128 contiguous bytes of a W row) and a k-slice of
// kchunk rows split over its 8 warps, and accumulates up to kGvMaxB = 8
// requests per W element: W is read once per decode step for a batch of up
// to 8 (gridDim.z takes each further 8), where the TPU grid (B, nn, nk)
// re-reads it per request.  Splitting k over
// gridDim.y puts enough blocks in flight to fill the card's memory
// pipeline; the ksplit partial sums go to scratch and finalize_kernel adds
// them in a fixed order (deterministic), then adds the rank-r term.
constexpr int kGvCols = 32, kGvWarps = 8, kGvMaxB = 8;

template <typename T>
__global__ void __launch_bounds__(kGvCols * kGvWarps)
gemv_partial_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    float* __restrict__ partial, int nb, int k, int n,
                    int kchunk) {
  __shared__ float red[kGvWarps][kGvMaxB][kGvCols];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int col = blockIdx.x * kGvCols + lane;
  const int b0 = blockIdx.z * kGvMaxB;
  const int nbb = min(kGvMaxB, nb - b0);
  const int k0 = blockIdx.y * kchunk;
  const int k1 = min(k, k0 + kchunk);
  float acc[kGvMaxB];
#pragma unroll
  for (int b = 0; b < kGvMaxB; ++b) acc[b] = 0.f;
  if (col < n) {
#pragma unroll 4
    for (int kk = k0 + warp; kk < k1; kk += kGvWarps) {
      const float wv = to_f(w[static_cast<size_t>(kk) * n + col]);
#pragma unroll
      for (int b = 0; b < kGvMaxB; ++b)
        if (b < nbb)
          acc[b] = fmaf(to_f(x[static_cast<size_t>(b0 + b) * k + kk]), wv,
                        acc[b]);
    }
  }
#pragma unroll
  for (int b = 0; b < kGvMaxB; ++b) red[warp][b][lane] = acc[b];
  __syncthreads();
  if (warp == 0 && col < n) {
    for (int b = 0; b < nbb; ++b) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kGvWarps; ++q) sum += red[q][b][lane];
      partial[(static_cast<size_t>(blockIdx.y) * nb + b0 + b) * n + col] = sum;
    }
  }
}

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

template <typename T>
int matmul_launch(const void* x, const void* w, const void* a, const void* b,
                  const int* ids, float* p, float* out, int nreq, int s, int k,
                  int n, int r, cudaStream_t st) {
  const int rows = nreq * s;
  shrink_kernel<T><<<dim3(rows, (r + kShrinkWarps - 1) / kShrinkWarps),
                     kShrinkWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), ids, p, rows, s, k,
      r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  matmul_kernel<T><<<dim3((n + kMmBN - 1) / kMmBN, (rows + kMmBM - 1) / kMmBM),
                     kMmThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), ids, p, out, rows, s, k, n, r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gemv_launch(const void* x, const void* w, const void* a, const void* b,
                const int* ids, float* p, float* partial, float* out, int nreq,
                int k, int n, int r, int ksplit, int kchunk, cudaStream_t st) {
  shrink_kernel<T><<<dim3(nreq, (r + kShrinkWarps - 1) / kShrinkWarps),
                     kShrinkWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), ids, p, nreq, 1, k,
      r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gemv_partial_kernel<T>
      <<<dim3((n + kGvCols - 1) / kGvCols, ksplit, (nreq + kGvMaxB - 1) / kGvMaxB),
         dim3(kGvCols, kGvWarps), 0, st>>>(static_cast<const T*>(x),
                                           static_cast<const T*>(w), partial,
                                           nreq, k, n, kchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = nreq * n;
  finalize_kernel<T><<<(total + 255) / 256, 256, 0, st>>>(
      partial, p, static_cast<const T*>(b), ids, out, nreq, n, r, ksplit);
  return static_cast<int>(cudaGetLastError());
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
    return matmul_launch<float>(x, w, a, b, ids, p, out, nreq, s, k, n, r, st);
  if (dtype == 1)
    return matmul_launch<__nv_bfloat16>(x, w, a, b, ids, p, out, nreq, s, k, n,
                                        r, st);
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
    return gemv_launch<float>(x, w, a, b, ids, p, partial, out, nreq, k, n, r,
                              ksplit, kchunk, st);
  if (dtype == 1)
    return gemv_launch<__nv_bfloat16>(x, w, a, b, ids, p, partial, out, nreq, k,
                                      n, r, ksplit, kchunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
