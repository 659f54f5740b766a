// Fused LoRA matmul, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/lora_matmul.py that
// make up its jax.custom_vjp (lora_matmul_vjp):
//   lora_fwd_launch    <- _fwd_kernel     y  = x W + gamma (x A^T) B^T,
//                                         p  = x A^T (residual)
//   lora_bwd_dx_launch <- _bwd_dx_kernel  dx = g W^T + gamma (g B) A,
//                                         q  = g B (residual)
//   lora_bwd_da_launch <- _bwd_da_kernel  dA = gamma q^T x
//   lora_bwd_db_launch <- _bwd_db_kernel  dB = gamma g^T p
// and the base-only GEMM over a packed frozen base (core/quant.py),
//   quant_matmul_launch <- _qmm_kernel    y  = x dequant(W)
// with x (m, k), W (k, n), A (r, k), B (n, r), g (m, n), p and q (m, r).
// x, W, A, B and g are fp32 or bf16 (one type for all); p and q are fp32;
// accumulation is fp32 FMA on the CUDA cores (no TF32), outputs are fp32.
// dW is never computed: the base is frozen.
//
// What bounds them on an H100, at the training path's shapes (m = 512
// rows, k = 2048, n = 2048 or 256, r = 64): #5 and #6 are bound by
// operations (2mkn for the base product, 67 TFLOP/s fp32 peak); #7 and #8
// are small (2mrk, 2mnr) and bound by the latency of their m loop.
//
// The TPU kernels carry p (forward) and q (backward) in VMEM from the first
// sweep of a sequential grid to the later blocks, and accumulate dA and dB
// in an output block the grid revisits.  GPU blocks run in no order, so:
//   - a rank pre-pass writes p or q to an fp32 (m, r) buffer first, and the
//     main kernel reads it in a second contraction (over r) after the base
//     product; the buffer is the residual the backward reuses;
//   - dA and dB give each block an output tile and loop over all m inside
//     the block, in a fixed order: no atomics, so a run repeats bit for bit.
// All four main passes are one tiled kernel (tile_kernel) that differs only
// in which operands are stored transposed.  Ragged edges are masked in the
// kernels: no shape needs padding.
//
// Plain C interface, bound with ctypes (kernels/build.py,
// kernels/lora_matmul.py).  Each entry point launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "gemv.cuh"
#include "loaders.cuh"

namespace {

using repro_kernels::gemv_partial_kernel;
using repro_kernels::Int4W;
using repro_kernels::Int8W;
using repro_kernels::kGvCols;
using repro_kernels::kGvMaxB;
using repro_kernels::kGvWarps;
using repro_kernels::log2_group;
using repro_kernels::to_f;

// --------------------------------------------------------- rank pre-passes
// p[row, j] = sum_k x[row, k] A[j, k]: both rows are contiguous along k, so
// one warp per (row, j), lanes striding over k, then a shuffle reduction.
constexpr int kRankWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kRankWarps * 32)
xat_kernel(const T* __restrict__ x, const T* __restrict__ a,
           float* __restrict__ p, int m, int k, int r) {
  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.y * kRankWarps + warp;
  if (row >= m || j >= r) return;  // uniform across the warp
  const T* xr = x + static_cast<size_t>(row) * k;
  const T* ar = a + static_cast<size_t>(j) * k;
  float acc = 0.f;
  for (int kk = lane; kk < k; kk += 32)
    acc = fmaf(to_f(xr[kk]), to_f(ar[kk]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) p[static_cast<size_t>(row) * r + j] = acc;
}

// q[row, j] = sum_n g[row, n] B[n, j]: B (n, r) is contiguous along j, so
// lanes take 32 consecutive j (coalesced reads of a B row, one broadcast
// read of g) and the 8 warps split n; the warps' partial sums are added in
// a fixed order.
template <typename T>
__global__ void __launch_bounds__(kRankWarps * 32)
gb_kernel(const T* __restrict__ g, const T* __restrict__ b,
          float* __restrict__ q, int m, int n, int r) {
  __shared__ float red[kRankWarps][32];
  const int row = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int j = blockIdx.y * 32 + lane;
  float acc = 0.f;
  if (row < m && j < r) {
    const T* gr = g + static_cast<size_t>(row) * n;
    for (int nn = warp; nn < n; nn += kRankWarps)
      acc = fmaf(to_f(gr[nn]), to_f(b[static_cast<size_t>(nn) * r + j]), acc);
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && row < m && j < r) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kRankWarps; ++w) sum += red[w][lane];
    q[static_cast<size_t>(row) * r + j] = sum;
  }
}

// ------------------------------------------------------------ tile kernel
// out[i, j] = scale * sum_t L(i, t) R(t, j)
//           + gamma * sum_s L2(i, s) R2(s, j)        (when l2 != nullptr)
// over an I x J output.  64 x 64 output tile per block, t in steps of 16
// through shared memory, 256 threads with 4 x 4 outputs each (rows
// ty + 16 i, cols tx + 16 j: shared-memory reads are broadcasts or
// conflict-free).  Each operand is a row-major matrix with leading
// dimension ld, stored either contiguous along the contraction index
// (kTC: element (i, t) at i * ld + t) or across it (t * ld + i); the load
// maps neighbouring threads to neighbouring addresses in both cases.
constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

// s[tt][w] = M(i0 + w, t0 + tt), zero outside ilim x tlim.
template <int kW, bool kTC, typename T>
__device__ __forceinline__ void load_slab(float (*s)[kW + 1],
                                          const T* __restrict__ ptr, int ld,
                                          int i0, int ilim, int t0, int tlim,
                                          int tid) {
#pragma unroll
  for (int e = 0; e < (kW * kBK) / kThreads; ++e) {
    const int idx = tid + e * kThreads;
    const int w = kTC ? idx / kBK : idx % kW;
    const int tt = kTC ? idx % kBK : idx / kW;
    const int gi = i0 + w, gt = t0 + tt;
    float v = 0.f;
    if (gi < ilim && gt < tlim)
      v = to_f(kTC ? ptr[static_cast<size_t>(gi) * ld + gt]
                   : ptr[static_cast<size_t>(gt) * ld + gi]);
    s[tt][w] = v;
  }
}

// acc[i][j] += sum_kk ls[kk][ty + 16 i] rs[kk][tx + 16 j] over one staged
// pair of slabs.
__device__ __forceinline__ void fma_slab(float (&acc)[4][4],
                                         float (*ls)[kBM + 1],
                                         float (*rs)[kBN + 1], int tx,
                                         int ty) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    float lv[4], rv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) lv[i] = ls[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) rv[j] = rs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(lv[i], rv[j], acc[i][j]);
  }
}

template <bool kLTC, bool kRTC, typename LT, typename RT>
__device__ __forceinline__ void contract(float (&acc)[4][4],
                                         float (*ls)[kBM + 1],
                                         float (*rs)[kBN + 1],
                                         const LT* __restrict__ l, int ldl,
                                         const RT* __restrict__ r, int ldr,
                                         int i0, int ni, int j0, int nj,
                                         int nt) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int t0 = 0; t0 < nt; t0 += kBK) {
    load_slab<kBM, kLTC>(ls, l, ldl, i0, ni, t0, nt, tid);
    load_slab<kBN, kRTC>(rs, r, ldr, j0, nj, t0, nt, tid);
    __syncthreads();
    fma_slab(acc, ls, rs, tx, ty);
    __syncthreads();
  }
}

template <typename LT, typename RT, bool kLTC, bool kRTC, typename R2T,
          bool kR2TC>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const LT* __restrict__ l, int ldl, const RT* __restrict__ r,
            int ldr, int ni, int nj, int nt, const float* __restrict__ l2,
            int ldl2, const R2T* __restrict__ r2, int ldr2, int nt2,
            float scale, float gamma, float* __restrict__ out) {
  __shared__ float ls[kBK][kBM + 1];
  __shared__ float rs[kBK][kBN + 1];
  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4], acc2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = acc2[i][j] = 0.f;
  contract<kLTC, kRTC>(acc, ls, rs, l, ldl, r, ldr, i0, ni, j0, nj, nt);
  if (l2 != nullptr)  // uniform: the rank-r term, after the base product
    contract<true, kR2TC>(acc2, ls, rs, l2, ldl2, r2, ldr2, i0, ni, j0, nj,
                          nt2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ty + 16 * i;
    if (gi >= ni) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = j0 + tx + 16 * j;
      if (gj < nj)
        out[static_cast<size_t>(gi) * nj + gj] =
            scale * acc[i][j] + gamma * acc2[i][j];
    }
  }
}

// --------------------------------------------------------- packed GEMM
// y = x dequant(W) over a packed frozen base: the tile above with no rank
// term, its W slab loaded through the int8 / int4 loader (loaders.cuh),
// which forms each fp32 element as core/quant.dequantize does.  The TPU
// kernel accumulates over a sequential k grid; here the k loop is inside
// the block, so no reduction crosses blocks.  x's columns (and W's rows)
// are masked at the logical k, below the padded kq of an int4 W.
// It serves m > 8 rows (admission prefills); decode shapes take the GEMV
// form below.
template <typename T, typename WL>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const T* __restrict__ x, const WL wl, float* __restrict__ y,
           int m, int k, int n) {
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int t0 = 0; t0 < k; t0 += kBK) {
    load_slab<kBM, true>(xs, x, k, i0, m, t0, k, tid);
#pragma unroll
    for (int e = 0; e < (kBN * kBK) / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int w = idx % kBN, tt = idx / kBN;
      const int gt = t0 + tt, gj = j0 + w;
      ws[tt][w] = (gt < k && gj < n) ? wl(gt, gj) : 0.f;
    }
    __syncthreads();
    fma_slab(acc, xs, ws, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ty + 16 * i;
    if (gi >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = j0 + tx + 16 * j;
      if (gj < n) y[static_cast<size_t>(gi) * n + gj] = acc[i][j];
    }
  }
}

inline dim3 tile_grid(int ni, int nj) {
  return dim3((nj + kBN - 1) / kBN, (ni + kBM - 1) / kBM);
}

template <typename T>
int fwd(const void* x, const void* w, const void* a, const void* b, float* p,
        float* y, int m, int k, int n, int r, float gamma, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  xat_kernel<T><<<dim3(m, (r + kRankWarps - 1) / kRankWarps),
                  kRankWarps * 32, 0, st>>>(xt, static_cast<const T*>(a), p,
                                            m, k, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // L = x (m x k, along t), R = W (k x n, across t);
  // L2 = p (m x r), R2(s, j) = B[j, s] (n x r, along s)
  tile_kernel<T, T, true, false, T, true><<<tile_grid(m, n), kThreads, 0, st>>>(
      xt, k, static_cast<const T*>(w), n, m, n, k, p, r,
      static_cast<const T*>(b), r, r, 1.f, gamma, y);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dx(const void* g, const void* w, const void* a, const void* b,
           float* q, float* dx, int m, int k, int n, int r, float gamma,
           cudaStream_t st) {
  const T* gt = static_cast<const T*>(g);
  gb_kernel<T><<<dim3(m, (r + 31) / 32), kRankWarps * 32, 0, st>>>(
      gt, static_cast<const T*>(b), q, m, n, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // L = g (m x n, along t), R(t, j) = W[j, t] (k x n, along t);
  // L2 = q (m x r), R2 = A (r x k, across s)
  tile_kernel<T, T, true, true, T, false><<<tile_grid(m, k), kThreads, 0, st>>>(
      gt, n, static_cast<const T*>(w), n, m, k, n, q, r,
      static_cast<const T*>(a), k, r, 1.f, gamma, dx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_da(const float* q, const void* x, float* da, int m, int k, int r,
           float gamma, cudaStream_t st) {
  // out (r x k): L(i, t) = q[t, i] (m x r, across t), R = x (m x k)
  tile_kernel<float, T, false, false, float, false>
      <<<tile_grid(r, k), kThreads, 0, st>>>(
          q, r, static_cast<const T*>(x), k, r, k, m, nullptr, 0, nullptr, 0,
          0, gamma, 0.f, da);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_db(const void* g, const float* p, float* db, int m, int n, int r,
           float gamma, cudaStream_t st) {
  // out (n x r): L(i, t) = g[t, i] (m x n, across t), R = p (m x r)
  tile_kernel<T, float, false, false, float, false>
      <<<tile_grid(n, r), kThreads, 0, st>>>(
          static_cast<const T*>(g), n, p, r, n, r, m, nullptr, 0, nullptr, 0,
          0, gamma, 0.f, db);
  return static_cast<int>(cudaGetLastError());
}

// y[i] = sum over ks of partial[ks][i], in a fixed order.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ y, int total,
                                    int ksplit) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float acc = 0.f;
  for (int q = 0; q < ksplit; ++q)
    acc += partial[static_cast<size_t>(q) * total + idx];
  y[idx] = acc;
}

// Decode form (m <= kGvMaxB rows): the tile above would loop over all of k
// in 16-row steps for every output tile, bound by that loop's latency
// (about 3 ms for an int4 w_down at m = 4 on an H100, PERF.md); the split-k
// GEMV of gemv.cuh reads each packed W element once and spreads k over
// blocks, then sum_partials_kernel adds the ksplit partials.
template <typename T, typename WL>
int qmm_launch(const T* x, const WL wl, float* partial, float* y, int m,
               int k, int n, int ksplit, int kchunk, cudaStream_t st) {
  if (m > kGvMaxB) {
    qmm_kernel<T, WL><<<tile_grid(m, n), kThreads, 0, st>>>(x, wl, y, m, k, n);
    return static_cast<int>(cudaGetLastError());
  }
  gemv_partial_kernel<T, WL>
      <<<dim3((n + kGvCols - 1) / kGvCols, ksplit, 1), dim3(kGvCols, kGvWarps),
         0, st>>>(x, wl, partial, m, k, n, kchunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<(m * n + 255) / 256, 256, 0, st>>>(partial, y, m * n,
                                                           ksplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int qmm(const void* x, const void* wd, const float* ws, float* partial,
        float* y, int m, int k, int n, int ksplit, int kchunk, int bits,
        int group, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (bits == 8)
    return qmm_launch<T>(xt, Int8W{static_cast<const int8_t*>(wd), ws, n},
                         partial, y, m, k, n, ksplit, kchunk, st);
  if (bits == 4)
    return qmm_launch<T>(
        xt, Int4W{static_cast<const uint8_t*>(wd), ws, n, log2_group(group)},
        partial, y, m, k, n, ksplit, kchunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w, a, b, g all of that type).
// p: (m, r) fp32, written (the residual, or scratch); y: (m, n) fp32.
int lora_fwd_launch(const void* x, const void* w, const void* a,
                    const void* b, float* p, float* y, int m, int k, int n,
                    int r, float gamma, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, w, a, b, p, y, m, k, n, r, gamma, st);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, w, a, b, p, y, m, k, n, r, gamma, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q: (m, r) fp32, written; dx: (m, k) fp32.
int lora_bwd_dx_launch(const void* g, const void* w, const void* a,
                       const void* b, float* q, float* dx, int m, int k, int n,
                       int r, float gamma, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_dx<float>(g, w, a, b, q, dx, m, k, n, r, gamma, st);
  if (dtype == 1)
    return bwd_dx<__nv_bfloat16>(g, w, a, b, q, dx, m, k, n, r, gamma, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q: (m, r) fp32; x of the dtype; da: (r, k) fp32.
int lora_bwd_da_launch(const float* q, const void* x, float* da, int m, int k,
                       int r, float gamma, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_da<float>(q, x, da, m, k, r, gamma, st);
  if (dtype == 1) return bwd_da<__nv_bfloat16>(q, x, da, m, k, r, gamma, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// g of the dtype; p: (m, r) fp32; db: (n, r) fp32.
int lora_bwd_db_launch(const void* g, const float* p, float* db, int m, int n,
                       int r, float gamma, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_db<float>(g, p, db, m, n, r, gamma, st);
  if (dtype == 1) return bwd_db<__nv_bfloat16>(g, p, db, m, n, r, gamma, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (m, k) of dtype; W packed: wd int8 (k, n) with ws (1, n) when
// bits == 8, uint8 (kq/2, n) with ws (kq/group, n) when bits == 4;
// y: (m, n) fp32.  When m <= 8 (the decode form) partial is a
// (ksplit, m, n) fp32 scratch and the k range splits into ksplit chunks of
// kchunk; otherwise partial, ksplit and kchunk are unused.
int quant_matmul_launch(const void* x, const void* wd, const float* ws,
                        float* partial, float* y, int m, int k, int n,
                        int ksplit, int kchunk, int bits, int group, int dtype,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return qmm<float>(x, wd, ws, partial, y, m, k, n, ksplit, kchunk, bits,
                      group, st);
  if (dtype == 1)
    return qmm<__nv_bfloat16>(x, wd, ws, partial, y, m, k, n, ksplit, kchunk,
                              bits, group, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
