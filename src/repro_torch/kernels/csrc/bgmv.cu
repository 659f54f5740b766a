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
// ids == nullptr means the identity map (row i <-> adapter i).  The two
// prefill forms are one body, templated on the W stager; the two decode
// forms another, templated on the format of a W row.
//
// The TPU kernel carries p = x A^T in VMEM from the n == 0 sweep to later
// n-blocks; GPU blocks run in no order.  The prefill forms (#2, #3) are the
// rank-fused forward tile of fwd_tile.cuh (shared with #5 and #9): a tiled
// pre-pass writes p to an fp32 scratch, then 128 x 128 output tiles over
// chunks of k planned on the host to fill the SMs, with the rank term
// contracted in the same ring, and a fixed-order pass over the chunks'
// partial sums; what bounds them and what the design does about it is set
// out there.  The decode forms (#1, #4) are the decode GEMV of qgemv.cuh
// (shared with #11's decode form): the GEMV forms each k-chunk's partials
// of x W and of p from the x it holds in shared memory, and a fixed-order
// pass adds them and p B^T.
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
#include "loaders.cuh"
#include "qgemv.cuh"

namespace {

using repro_kernels::bgmv_gemv_body;
using repro_kernels::FwdPlan;
using repro_kernels::fwd_rank_fused;
using repro_kernels::fwd_vec;
using repro_kernels::with_dense_cols;
using repro_kernels::with_packed_cols;

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

// The packed prefill form: the same launch with an int8 or int4 W.
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

// p: (ksplit, nreq, r) fp32 scratch; partial: (ksplit, nreq, n) fp32
// scratch; out: (nreq, n) fp32.  The k range splits into ksplit chunks of
// kchunk (kernels/common.py gemv_plan); the decode GEMV of qgemv.cuh.
int bgmv_gemv_launch(const void* x, const void* w, const void* a,
                     const void* b, const int* ids, float* p, float* partial,
                     float* out, int nreq, int k, int n, int r, int ksplit,
                     int kchunk, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return bgmv_gemv_body(x, dtype == 1, w, nullptr, a, b, ids, p, partial, out,
                        nreq, k, n, r, ksplit, kchunk, 0, 0, 0,
                        static_cast<cudaStream_t>(stream));
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
  if ((dtype != 0 && dtype != 1) || (bits != 8 && bits != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  return bgmv_gemv_body(x, dtype == 1, wd, ws, a, b, ids, p, partial, out,
                        nreq, k, n, r, ksplit, kchunk, bits, group, bf16w,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
