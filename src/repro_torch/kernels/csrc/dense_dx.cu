// The dense LoRA dx (#6), for Hopper (sm_90a):
//   lora_bwd_dx_launch <- _bwd_dx_kernel  dx = g W^T + gamma (g B) A,
//                                         q  = g B (residual)
// of src/repro/kernels/lora_matmul.py (:147 via _bwd_dx_call, pallas_call
// :182), with g (m, n), W (k, n), A (r, k), B (n, r) of one type (fp32 or
// bf16), q (m, r) and dx (m, k) fp32; accumulation is fp32 FMA on the CUDA
// cores (no TF32).  Its own translation unit beside lora_matmul.cu and
// packed_dx.cu, so that the three parts of the LoRA matmul's
// instantiations of the forward tile build in parallel.
//
// What bounds it on an H100 at the training path's shapes (m = 512, k =
// 2048, n = 2048 (q) or 256 (v), r = 64): operations, 2 m n k + 2 m r (n +
// k) of fp32 FMA (68.11 / 10.27 us at 67 TFLOP/s).  It is #10's rank-fused
// dx (fwd_tile.cuh dx_rank_fused) over a dense W: a q = g B pre-pass (B
// row-major as the right operand, n split in 1-slab chunks), then g (Rows)
// against W read by row (ColsT: element (t, j) = W[j * n + t]) with gamma q
// A (A row-major, scaled by gamma as it is staged) as the contraction's
// tail, over 128 x 128 tiles and chunks of the range [0, roundup(n, 16) +
// r) planned on the host (kernels/common.py dx_rank_plan), the chunks'
// partials added in a fixed order (no atomics).  It replaced a q pre-pass
// of one warp per (row, 32 rank columns) and a 64 x 64 tile with 4 x 4
// outputs a thread, element-wise register staging and the rank term as a
// second contraction, at 2.44x torch.matmul at q (PERF.md).  Ragged edges
// are masked; off the vector conditions (k, n, r multiples of 4, aligned
// operands) the scalar path stages element by element.
//
// Plain C interface, bound with ctypes (kernels/build.py,
// kernels/lora_matmul.py).  The entry point launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fwd_tile.cuh"

namespace {

using repro_kernels::FwdPlan;
using repro_kernels::dx_rank_fused;
using repro_kernels::fwd_vec;
using repro_kernels::with_dense_rows;

// #6: the rank-fused dx of fwd_tile.cuh (dx_rank_fused, as #10 over a
// packed W): a q = g B pre-pass, then g against the dense W read by row
// (ColsT) with gamma q A as the contraction's tail, over the host's plan
// (kernels/common.py dx_rank_plan).
template <typename T>
int bwd_dx(const void* g, const void* w, const void* a, const void* b,
           float* q, float* scratch, float* dx, int m, int k, int n, int r,
           const FwdPlan& plan, float gamma, cudaStream_t st) {
  // fwd_vec's conditions with the roles swapped: the contraction is n
  return with_dense_rows(
      static_cast<const T*>(w), n, k, fwd_vec(n, k, r, g, a, b, q),
      [&](const auto& wv) {
        return dx_rank_fused<T>(static_cast<const T*>(g), wv,
                                static_cast<const T*>(a),
                                static_cast<const T*>(b), gamma, q, scratch,
                                dx, m, k, n, r, plan, st);
      });
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (g, w, a, b all of that type).
// q: (m, r) fp32, written; dx: (m, k) fp32; scratch the partials of the
// plan's split passes (kernels/common.py dx_rank_plan: the q pre-pass
// contracts n in ksplit_p chunks of kchunk_p, the main pass its range [0,
// roundup(n, 16) + r) in ksplit chunks of kchunk), unused when neither
// splits.
int lora_bwd_dx_launch(const void* g, const void* w, const void* a,
                       const void* b, float* q, float* scratch, float* dx,
                       int m, int k, int n, int r, int ksplit_p, int kchunk_p,
                       int ksplit, int kchunk, float gamma, int dtype,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FwdPlan plan{ksplit_p, kchunk_p, ksplit, kchunk};
  if (dtype == 0)
    return bwd_dx<float>(g, w, a, b, q, scratch, dx, m, k, n, r, plan, gamma,
                         st);
  if (dtype == 1)
    return bwd_dx<__nv_bfloat16>(g, w, a, b, q, scratch, dx, m, k, n, r, plan,
                                 gamma, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
