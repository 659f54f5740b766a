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
// n-blocks; GPU blocks run in no order, so a pre-pass writes p to an fp32
// scratch (B*s, r) that the main kernels read.  The prefill forms (#2, #3)
// are the rank-fused forward tile of fwd_tile.cuh (shared with #5 and #9):
// its tiled pre-pass, then 128 x 128 output tiles over chunks of k planned
// on the host to fill the SMs, with the rank term contracted in the same
// ring, and a fixed-order pass over the chunks' partial sums; what bounds
// them and what the design does about it is set out there.  The decode
// forms (#1, #4) keep the warp-per-(row, j) shrink_kernel (4 rows) and the
// split-k GEMV of gemv.cuh.
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

#include "fwd_tile.cuh"
#include "gemv.cuh"
#include "loaders.cuh"

namespace {

using repro_kernels::DenseW;
using repro_kernels::FwdPlan;
using repro_kernels::fwd_rank_fused;
using repro_kernels::fwd_vec;
using repro_kernels::gemv_partial_kernel;
using repro_kernels::kGvCols;
using repro_kernels::kGvMaxB;
using repro_kernels::kGvWarps;
using repro_kernels::to_f;
using repro_kernels::with_dense_cols;
using repro_kernels::with_packed_cols;
using repro_kernels::with_packed_w;

// ------------------------------------------------------------- shrink
// The decode forms' pre-pass: p[b, j] = sum_k x[b, k] * A[id(b), j, k],
// one warp per (request b, j): the warp's lanes stride over k (coalesced
// reads of the x row and the A row), then reduce with shuffles.
constexpr int kShrinkWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kShrinkWarps * 32)
shrink_kernel(const T* __restrict__ x, const T* __restrict__ a,
              const int* __restrict__ ids, float* __restrict__ p, int rows,
              int k, int r) {
  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.y * kShrinkWarps + warp;
  if (row >= rows || j >= r) return;  // uniform across the warp
  const int id = ids ? ids[row] : row;
  const T* xr = x + static_cast<size_t>(row) * k;
  const T* ar = a + (static_cast<size_t>(id) * r + j) * k;
  float acc = 0.f;
  for (int kk = lane; kk < k; kk += 32) acc = fmaf(to_f(xr[kk]), to_f(ar[kk]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) p[static_cast<size_t>(row) * r + j] = acc;
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

// Prefill form (#2, #3): the rank-fused forward tile of fwd_tile.cuh over
// the bank (adapter of row i: ids[i / s], or i / s), gamma 1.
template <typename T, typename WS>
int matmul_launch(const void* x, const WS& w, const void* a, const void* b,
                  const int* ids, float* p, float* scratch, float* out,
                  int nreq, int s, int k, int n, int r, const FwdPlan& plan,
                  cudaStream_t st) {
  return fwd_rank_fused<T>(static_cast<const T*>(x), w,
                           static_cast<const T*>(a), static_cast<const T*>(b),
                           static_cast<size_t>(r) * k,
                           static_cast<size_t>(n) * r, ids, s, 1.f, p,
                           scratch, out, nreq * s, k, n, r, plan, st);
}

template <typename T, typename WL>
int gemv_launch(const void* x, const WL wl, const void* a, const void* b,
                const int* ids, float* p, float* partial, float* out, int nreq,
                int k, int n, int r, int ksplit, int kchunk, cudaStream_t st) {
  shrink_kernel<T><<<dim3(nreq, (r + kShrinkWarps - 1) / kShrinkWarps),
                     kShrinkWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), ids, p, nreq, k, r);
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

// The packed forms: the same launches with an int8 or int4 W.
template <typename T>
int matmul_quant(const void* x, const void* wd, const float* ws, const void* a,
                 const void* b, const int* ids, float* p, float* scratch,
                 float* out, int nreq, int s, int k, int n, int r,
                 const FwdPlan& plan, int bits, int group, int bf16w,
                 cudaStream_t st) {
  return with_packed_cols(
      wd, ws, n, bits, group, bf16w, fwd_vec(k, n, r, x, a, b, p),
      [&](const auto& w) {
        return matmul_launch<T>(x, w, a, b, ids, p, scratch, out, nreq, s, k,
                                n, r, plan, st);
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
// p: (nreq * s, r) fp32 scratch; out: (nreq * s, n) fp32; scratch: the
// partial sums of the plan's split passes (fwd_tile.cuh fwd_rank_fused),
// unused when neither splits.
int bgmv_matmul_launch(const void* x, const void* w, const void* a,
                       const void* b, const int* ids, float* p, float* scratch,
                       float* out, int nreq, int s, int k, int n, int r,
                       int ksplit_p, int kchunk_p, int ksplit, int kchunk,
                       int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FwdPlan plan{ksplit_p, kchunk_p, ksplit, kchunk};
  const bool vec = fwd_vec(k, n, r, x, a, b, p);
  if (dtype == 0)
    return with_dense_cols(static_cast<const float*>(w), n, vec,
                           [&](const auto& wv) {
                             return matmul_launch<float>(
                                 x, wv, a, b, ids, p, scratch, out, nreq, s, k,
                                 n, r, plan, st);
                           });
  if (dtype == 1)
    return with_dense_cols(static_cast<const __nv_bfloat16*>(w), n, vec,
                           [&](const auto& wv) {
                             return matmul_launch<__nv_bfloat16>(
                                 x, wv, a, b, ids, p, scratch, out, nreq, s, k,
                                 n, r, plan, st);
                           });
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
                             float* p, float* scratch, float* out, int nreq,
                             int s, int k, int n, int r, int ksplit_p,
                             int kchunk_p, int ksplit, int kchunk, int bits,
                             int group, int bf16w, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FwdPlan plan{ksplit_p, kchunk_p, ksplit, kchunk};
  if (dtype == 0)
    return matmul_quant<float>(x, wd, ws, a, b, ids, p, scratch, out, nreq, s,
                               k, n, r, plan, bits, group, bf16w, st);
  if (dtype == 1)
    return matmul_quant<__nv_bfloat16>(x, wd, ws, a, b, ids, p, scratch, out,
                                       nreq, s, k, n, r, plan, bits, group,
                                       bf16w, st);
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
