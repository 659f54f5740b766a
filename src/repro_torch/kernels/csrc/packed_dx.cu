// The packed dx forms of the LoRA matmul, for Hopper (sm_90a), over a
// frozen base packed int8 / int4 (core/quant.py, W = dequant(W), W of
// logical shape (k, n)):
//   lora_bwd_dx_quant_launch <- _bwd_dx_kernel_q (#10)  dx = g dequant(W)^T
//                               + gamma (g B) A, q = g B (residual)
//   quant_matmul_dx_launch   <- _qmm_dx_kernel   (#12)  dx = g dequant(W)^T
// of src/repro/kernels/lora_matmul.py (:414 via _bwd_dx_call_q, and :544 via
// _qmm_dx_call), with g (m, n), A (r, k), B (n, r) of one type (fp32 or
// bf16), q (m, r) and dx (m, k) fp32.  Their own translation unit beside
// lora_matmul.cu, so that the two halves of the LoRA matmul's
// instantiations of the forward tile build in parallel.
//
// What bounds them on an H100 at the training path's shapes (m = 512; k =
// 2048; n = 2048 (q, o), 256 (v, k) or 16384 (the MLP)): operations, 2 m n
// k (+ 2 m r (n + k) for #10) of fp32 FMA on the CUDA cores (67 TFLOP/s).
// Both contract along W's contiguous n, so they read W by row: the rank-
// fused forward tile of fwd_tile.cuh with g as the left operand (Rows) and
// W through RowsInt8 / RowsInt4 (one 32-bit word is 4 elements along n of
// one row, or of two for int4, decoded without I2F and stored transposed),
// n split over grid z by the host (kernels/common.py dx_plan) where the
// (m, k) output's 128 x 128 tiles leave SMs idle, the chunks' partials
// added in a fixed order.  #12 has no rank term.  #10 replaced a q = g B
// pre-pass of one warp per (row, 32 j) and a 64 x 64 tile (2.56x
// torch.matmul at q): its q pre-pass is the same body (B row-major as the
// right operand, n split in 1-slab chunks, dx_rank_plan), and gamma q A
// (A row-major, scaled by gamma as it is staged) is the main pass's tail,
// contracted in the same ring after n (dx_rank_fused).  Each W element is
// dequantize's fp32 product float(q) * scale, rounded to bf16 for a base
// packed from bf16 weights, so kernel and plain version differ only in the
// order of their sums.  Ragged edges are masked; an int4 W's kq - k padding
// rows are never read.
//
// Plain C interface, bound with ctypes (kernels/build.py,
// kernels/lora_matmul.py).  Each entry point launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fwd_tile.cuh"

namespace {

using repro_kernels::FwdPlan;
using repro_kernels::dx_rank_fused;
using repro_kernels::fwd_base_only;
using repro_kernels::fwd_vec;
using repro_kernels::is_aligned;
using repro_kernels::with_packed_rows;

// #10: the rank-fused dx (fwd_tile.cuh dx_rank_fused): a q = g B pre-pass,
// then g against W read by row (RowsInt8 / RowsInt4, as #12) with gamma q A
// as the contraction's tail, over the host's plan (kernels/common.py
// dx_plan with r).
template <typename T>
int bwd_dx_quant(const void* g, const void* wd, const float* ws,
                 const void* a, const void* b, float* q, float* scratch,
                 float* dx, int m, int k, int n, int r, const FwdPlan& plan,
                 float gamma, int bits, int group, int bf16w,
                 cudaStream_t st) {
  // fwd_vec's conditions with the roles swapped: the contraction is n
  return with_packed_rows(
      wd, ws, n, k, bits, group, bf16w, fwd_vec(n, k, r, g, a, b, q),
      [&](const auto& w) {
        return dx_rank_fused<T>(static_cast<const T*>(g), w,
                                static_cast<const T*>(a),
                                static_cast<const T*>(b), gamma, q, scratch,
                                dx, m, k, n, r, plan, st);
      });
}

// #12: dx = g dequant(W)^T on the rank-fused forward body of fwd_tile.cuh
// with no rank term: g (m, n) is the left operand (Rows), W read by row the
// right one (RowsInt8 / RowsInt4), contracting n in ksplit chunks of kchunk
// (kernels/common.py dx_plan) whose partials a fixed-order pass adds.
template <typename T>
int qmm_dx(const void* g, const void* wd, const float* ws, float* scratch,
           float* dx, int m, int k, int n, int ksplit, int kchunk, int bits,
           int group, int bf16w, cudaStream_t st) {
  return with_packed_rows(
      wd, ws, n, k, bits, group, bf16w, n % 4 == 0 && is_aligned(g, 16),
      [&](const auto& w) {
        return fwd_base_only<T>(static_cast<const T*>(g), w, scratch, dx, m,
                                n, k, ksplit, kchunk, st);
      });
}

}  // namespace

extern "C" {

// Over a packed W (logical (k, n)): wd int8 (k, n) with ws (1, n) when
// bits == 8, uint8 (kq/2, n) with ws (kq/group, n) when bits == 4; bf16w = 1
// for a base packed from bf16 weights.  g, a, b of dtype (0 = float32, 1 =
// bfloat16); outputs fp32.

// #10: q (m, r) fp32, written; dx (m, k); scratch the partials of the
// plan's split passes (kernels/common.py dx_rank_plan: the q pre-pass
// contracts n in ksplit_p chunks of kchunk_p, the main pass its range [0,
// roundup(n, 16) + r) in ksplit chunks of kchunk), unused when neither
// splits.
int lora_bwd_dx_quant_launch(const void* g, const void* wd, const float* ws,
                             const void* a, const void* b, float* q,
                             float* scratch, float* dx, int m, int k, int n,
                             int r, int ksplit_p, int kchunk_p, int ksplit,
                             int kchunk, float gamma, int bits, int group,
                             int bf16w, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FwdPlan plan{ksplit_p, kchunk_p, ksplit, kchunk};
  if (dtype == 0)
    return bwd_dx_quant<float>(g, wd, ws, a, b, q, scratch, dx, m, k, n, r,
                               plan, gamma, bits, group, bf16w, st);
  if (dtype == 1)
    return bwd_dx_quant<__nv_bfloat16>(g, wd, ws, a, b, q, scratch, dx, m, k,
                                       n, r, plan, gamma, bits, group, bf16w,
                                       st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// #12: dx (m, k).  The contraction over n runs in ksplit chunks of kchunk
// (whole 16-element slabs); when ksplit > 1, scratch is a (ksplit, m, k)
// fp32 buffer for the chunks' partials, else unused.
int quant_matmul_dx_launch(const void* g, const void* wd, const float* ws,
                           float* scratch, float* dx, int m, int k, int n,
                           int ksplit, int kchunk, int bits, int group,
                           int bf16w, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return qmm_dx<float>(g, wd, ws, scratch, dx, m, k, n, ksplit, kchunk,
                         bits, group, bf16w, st);
  if (dtype == 1)
    return qmm_dx<__nv_bfloat16>(g, wd, ws, scratch, dx, m, k, n, ksplit,
                                 kchunk, bits, group, bf16w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
