// Fused LoRA matmul, forward and backward, for Hopper (sm_90a), over an fp
// or a packed frozen base.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/lora_matmul.py that
// make up its jax.custom_vjp's (lora_matmul_vjp, lora_matmul_quant_vjp,
// quant_matmul_vjp):
//   lora_fwd_launch          <- _fwd_kernel       y  = x W + gamma (x A^T) B^T,
//                                                 p  = x A^T (residual)
//   (lora_bwd_dx_launch      <- _bwd_dx_kernel    dx = g W^T + gamma (g B) A,
//                                                 q  = g B, in dense_dx.cu)
//   (lora_bwd_da_launch      <- _bwd_da_kernel    dA = gamma q^T x,
//    lora_bwd_db_launch      <- _bwd_db_kernel    dB = gamma g^T p,
//                                                 in lora_grads.cu)
// and over a packed frozen base (core/quant.py, W = dequant(W)):
//   lora_fwd_quant_launch    <- _fwd_kernel_q     #5 over a packed W
//   quant_matmul_launch      <- _qmm_kernel       y  = x dequant(W)
// (the packed dx forms, #10 and #12, are in packed_dx.cu)
// with x (m, k), W (k, n), A (r, k), B (n, r), g (m, n), p and q (m, r).
// x, W, A, B and g are fp32 or bf16 (one type for all); p and q are fp32;
// accumulation is fp32 FMA on the CUDA cores (no TF32), outputs are fp32.
// dW is never computed: the base is frozen.
//
// What bounds them on an H100, at the training path's shapes (m = 512
// rows, k = 2048, n = 2048 or 256, r = 64; the MLP's 16384): the base
// products are bound by operations (2mkn, 67 TFLOP/s fp32 peak), a packed
// W no less (its fewer bytes only lower a bound that was not binding).
// #11's decode form (m <= 8 rows) is bound by W's packed bytes instead.
//
// The TPU kernels carry p (forward) in VMEM from the first sweep of a
// sequential grid to the later blocks.  GPU blocks run in no order, so a
// rank pre-pass writes p to an fp32 (m, r) buffer first, and the main
// kernel reads it as the tail of its contraction (over r) after the base
// product; the buffer is the residual the backward reuses.
// #5, #9 and #11's prefill form run on the rank-fused forward tile of
// fwd_tile.cuh, shared with the BGMV prefill (#2, #3) and the dx forms
// (#6, dense_dx.cu; #10, #12, packed_dx.cu): a tiled pre-pass for p, then
// 128 x 128 output tiles (8 x 8 per thread, a cp.async ring) over chunks of
// k planned on the host to fill the SMs, the rank term contracted in the
// same ring, and a fixed-order pass over the chunks' partial sums; W is
// read by column (ColsDense, ColsInt8 / ColsInt4: a packed W decoded one
// 32-bit word at a time).  What bounds them and what the design does about
// it is set out there.  #11 (no rank term) replaced a 64 x 64 tile that
// ran at 2.7x torch.matmul.  #11's decode form (m <= 8 rows) is the decode
// GEMV of qgemv.cu (16-byte loads of W into a per-warp ring, word-wide
// decode, x in shared memory; shared with #1 / #4 of bgmv.cu), which
// replaced a split-k GEMV at 21x its byte bound.  #7 and #8, which reduce
// over m, are the cluster-reduced kernel of lora_grads.cu.  Ragged edges
// are masked in the kernels: no shape needs padding, and an int4 W's kq - k
// padding rows are never read.
//
// Plain C interface, bound with ctypes (kernels/build.py,
// kernels/lora_matmul.py).  Each entry point launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "fwd_tile.cuh"
#include "loaders.cuh"
#include "qgemv.cuh"

namespace {

using repro_kernels::FwdPlan;
using repro_kernels::fwd_base_only;
using repro_kernels::fwd_rank_fused;
using repro_kernels::fwd_sum;
using repro_kernels::fwd_vec;
using repro_kernels::is_aligned;
using repro_kernels::kQgMaxRows;
using repro_kernels::qgemv_partial;
using repro_kernels::with_dense_cols;
using repro_kernels::with_packed_cols;

// #5 and #9: the rank-fused forward tile of fwd_tile.cuh (its pre-pass
// writes the residual p), one adapter (stride 0, every row request 0).
template <typename T, typename WS>
int fwd_launch(const void* x, const WS& w, const void* a, const void* b,
               float* p, float* scratch, float* y, int m, int k, int n, int r,
               const FwdPlan& plan, float gamma, cudaStream_t st) {
  return fwd_rank_fused<T>(static_cast<const T*>(x), w,
                           static_cast<const T*>(a), static_cast<const T*>(b),
                           0, 0, nullptr, m, gamma, p, scratch, y, m, k, n, r,
                           plan, st);
}

template <typename T>
int fwd(const void* x, const void* w, const void* a, const void* b, float* p,
        float* scratch, float* y, int m, int k, int n, int r,
        const FwdPlan& plan, float gamma, cudaStream_t st) {
  return with_dense_cols(static_cast<const T*>(w), n,
                         fwd_vec(k, n, r, x, a, b, p), [&](const auto& wv) {
                           return fwd_launch<T>(x, wv, a, b, p, scratch, y, m,
                                                k, n, r, plan, gamma, st);
                         });
}

// ------------------------------------------------- over a packed frozen W
// On the rank-fused forward body of fwd_tile.cuh, W decoded a word at a
// time by its packed stagers, each element formed as core/quant.dequantize
// forms it (loaders.cuh); #11's decode form on the packed GEMV of
// qgemv.cu.  x's columns (and W's rows) are masked at the logical k, below
// the padded kq of an int4 W.

// #9: #5 over a packed W.
template <typename T>
int fwd_quant(const void* x, const void* wd, const float* ws, const void* a,
              const void* b, float* p, float* scratch, float* y, int m, int k,
              int n, int r, const FwdPlan& plan, float gamma, int bits,
              int group, int bf16w, cudaStream_t st) {
  return with_packed_cols(wd, ws, n, bits, group, bf16w,
                          fwd_vec(k, n, r, x, a, b, p), [&](const auto& w) {
                            return fwd_launch<T>(x, w, a, b, p, scratch, y, m,
                                                 k, n, r, plan, gamma, st);
                          });
}

// #11: y = x dequant(W).  Both forms read each packed W element once per
// call and split k over a host plan, the chunks' partials (scratch) added
// in a fixed order.  m > kQgMaxRows (prefills, training; bound by
// operations): the forward body with no rank term, x through Rows, W by
// column through ColsInt8 / ColsInt4 (as #9), planned by
// kernels/common.py qmm_plan.  Decode form (m <= kQgMaxRows; bound by W's
// packed bytes): the packed GEMV of qgemv.cu, planned by qgemv_split.
template <typename T>
int qmm(const void* x, const void* wd, const float* ws, float* scratch,
        float* y, int m, int k, int n, int ksplit, int kchunk, int bits,
        int group, int bf16w, cudaStream_t st) {
  if (m > kQgMaxRows)
    return with_packed_cols(
        wd, ws, n, bits, group, bf16w,
        k % 4 == 0 && n % 4 == 0 && is_aligned(x, 16), [&](const auto& w) {
          return fwd_base_only<T>(static_cast<const T*>(x), w, scratch, y, m,
                                  k, n, ksplit, kchunk, st);
        });
  const int err =
      qgemv_partial(x, std::is_same<T, __nv_bfloat16>::value, wd, ws,
                    ksplit > 1 ? scratch : y, m, k, n, ksplit, kchunk, bits,
                    group, bf16w, st);
  if (err != 0 || ksplit == 1) return err;
  return fwd_sum(scratch, y, m * n, ksplit, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w, a, b, g all of that type).
// p: (m, r) fp32, written (the residual, or scratch); y: (m, n) fp32;
// scratch: the partial sums of the plan's split passes (fwd_tile.cuh
// fwd_rank_fused), unused when neither splits.
int lora_fwd_launch(const void* x, const void* w, const void* a,
                    const void* b, float* p, float* scratch, float* y, int m,
                    int k, int n, int r, int ksplit_p, int kchunk_p,
                    int ksplit, int kchunk, float gamma, int dtype,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FwdPlan plan{ksplit_p, kchunk_p, ksplit, kchunk};
  if (dtype == 0)
    return fwd<float>(x, w, a, b, p, scratch, y, m, k, n, r, plan, gamma, st);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, w, a, b, p, scratch, y, m, k, n, r, plan,
                              gamma, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Over a packed W (logical (k, n)): wd int8 (k, n) with ws (1, n) when
// bits == 8, uint8 (kq/2, n) with ws (kq/group, n) when bits == 4; bf16w = 1
// for a base packed from bf16 weights (each element rounded to bf16,
// loaders.cuh).  x, g, a, b of dtype; outputs fp32.
//
// #11: y (m, n).  The contraction over k runs in ksplit chunks of kchunk
// (kernels/common.py qgemv_split for m <= 8, the decode form; qmm_plan
// otherwise); when ksplit > 1, scratch is a (ksplit, m, n) fp32 buffer for
// the chunks' partials, else unused.
int quant_matmul_launch(const void* x, const void* wd, const float* ws,
                        float* scratch, float* y, int m, int k, int n,
                        int ksplit, int kchunk, int bits, int group, int bf16w,
                        int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return qmm<float>(x, wd, ws, scratch, y, m, k, n, ksplit, kchunk, bits,
                      group, bf16w, st);
  if (dtype == 1)
    return qmm<__nv_bfloat16>(x, wd, ws, scratch, y, m, k, n, ksplit, kchunk,
                              bits, group, bf16w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// #9: p (m, r) fp32, written (the residual, or scratch); y (m, n); scratch
// as for #5.
int lora_fwd_quant_launch(const void* x, const void* wd, const float* ws,
                          const void* a, const void* b, float* p,
                          float* scratch, float* y, int m, int k, int n, int r,
                          int ksplit_p, int kchunk_p, int ksplit, int kchunk,
                          float gamma, int bits, int group, int bf16w,
                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FwdPlan plan{ksplit_p, kchunk_p, ksplit, kchunk};
  if (dtype == 0)
    return fwd_quant<float>(x, wd, ws, a, b, p, scratch, y, m, k, n, r, plan,
                            gamma, bits, group, bf16w, st);
  if (dtype == 1)
    return fwd_quant<__nv_bfloat16>(x, wd, ws, a, b, p, scratch, y, m, k, n,
                                    r, plan, gamma, bits, group, bf16w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
