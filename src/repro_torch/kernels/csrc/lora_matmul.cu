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
//   lora_bwd_da_launch       <- _bwd_da_kernel    dA = gamma q^T x
//   lora_bwd_db_launch       <- _bwd_db_kernel    dB = gamma g^T p
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
// W no less (its fewer bytes only lower a bound that was not binding); #7
// and #8 are small (2mrk, 2mnr) and bound by the latency of their m loop,
// which they split over blocks.  #11's decode form (m <= 8 rows) is bound
// by W's packed bytes instead.
//
// The TPU kernels carry p (forward) and q (backward) in VMEM from the first
// sweep of a sequential grid to the later blocks, and accumulate dA and dB
// in an output block the grid revisits.  GPU blocks run in no order, so:
//   - a rank pre-pass writes p or q to an fp32 (m, r) buffer first, and the
//     main kernel reads it in a second contraction (over r) after the base
//     product; the buffer is the residual the backward reuses;
//   - dA and dB split the m loop into chunks, one block per (output tile,
//     chunk), and a second kernel adds the chunks' partial sums in a fixed
//     order: no atomics, so a run repeats bit for bit.
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
// replaced a split-k GEMV at 21x its byte bound.  #7 and #8 are one older
// tiled kernel (tile_kernel, 64 x 64 outputs) over element views of dense
// fp32 / bf16 matrices stored along or across the contraction, their m loop
// split over blocks.  Ragged edges are masked in the kernels: no shape
// needs padding, and an int4 W's kq - k padding rows are never read.
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
using repro_kernels::to_f;
using repro_kernels::with_dense_cols;
using repro_kernels::with_packed_cols;

// ------------------------------------------------------------ tile kernel
// out[i, j] = scale * sum_t L(i, t) R(j, t) over an I x J output (#7's dA
// and #8's dB).  64 x 64 output tile per block, t in steps of 16
// through shared memory, 256 threads with 4 x 4 outputs each (rows
// ty + 16 i, cols tx + 16 j: shared-memory reads are broadcasts or
// conflict-free).  Each operand is an element view (below) that fetches
// element (i, t), with i its output index (a row of L, a column of R) and t
// the contraction index, into registers (fetch) and turns it into fp32
// (cvt), and says how it is stored: kTC when it is contiguous along t.
// Staging maps neighbouring threads to neighbouring addresses in both
// cases.  The contraction loop is inside the block, so no sum crosses
// blocks, except over grid z: #7 / #8 split their m loop over it and a
// second kernel adds the parts in a fixed order (below).
//
// Each step's loads would otherwise wait in line behind its FMAs: the next
// slab's loads are issued into registers before the FMAs on the current
// one, converted and stored to a second shared-memory slab after them, so
// one barrier per step suffices.  The launch bound caps a thread at 128
// registers, so two blocks share an SM and each hides the other's barrier
// waits (PERF.md).
constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

// A row-major fp32 or bf16 matrix with leading dimension ld: element (i, t)
// at i * ld + t (kTC) or t * ld + i.
template <typename T, bool kTC_>
struct Dense {
  static constexpr bool kTC = kTC_;
  using Raw = T;
  const T* p;
  int ld;
  __device__ __forceinline__ Raw fetch(int i, int t) const {
    return __ldg(kTC ? p + static_cast<size_t>(i) * ld + t
                     : p + static_cast<size_t>(t) * ld + i);
  }
  static __device__ __forceinline__ float cvt(Raw v) { return to_f(v); }
};

// One thread's share of a kW x kBK slab of an operand, in registers, and
// whether each of its elements lies inside the operand.
template <int kW, typename Op>
struct Staged {
  static constexpr int kE = (kW * kBK) / kThreads;
  typename Op::Raw v[kE];
  bool in[kE];

  __device__ __forceinline__ static int w_of(int idx) {
    return Op::kTC ? idx / kBK : idx % kW;
  }
  __device__ __forceinline__ static int t_of(int idx) {
    return Op::kTC ? idx % kBK : idx / kW;
  }
  // elements (i0 + w, t0 + tt) of this thread; none past ilim x tlim
  __device__ __forceinline__ void fetch(const Op& op, int i0, int ilim,
                                        int t0, int tlim, int tid) {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int idx = tid + e * kThreads;
      const int gi = i0 + w_of(idx), gt = t0 + t_of(idx);
      in[e] = gi < ilim && gt < tlim;
      if (in[e]) v[e] = op.fetch(gi, gt);
    }
  }
  // s[tt][w] = the element as fp32, zero outside
  __device__ __forceinline__ void store(float (*s)[kW + 1], int tid) const {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int idx = tid + e * kThreads;
      s[t_of(idx)][w_of(idx)] = in[e] ? Op::cvt(v[e]) : 0.f;
    }
  }
};

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

template <typename LOp, typename ROp>
__device__ __forceinline__ void contract(float (&acc)[4][4],
                                         float (*ls)[kBK][kBM + 1],
                                         float (*rs)[kBK][kBN + 1],
                                         const LOp& l, const ROp& r, int i0,
                                         int ni, int j0, int nj, int t_lo,
                                         int t_hi) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  Staged<kBM, LOp> lst;
  Staged<kBN, ROp> rst;
  lst.fetch(l, i0, ni, t_lo, t_hi, tid);
  rst.fetch(r, j0, nj, t_lo, t_hi, tid);
  lst.store(ls[0], tid);
  rst.store(rs[0], tid);
  __syncthreads();
  int buf = 0;
  for (int t0 = t_lo; t0 < t_hi; t0 += kBK, buf ^= 1) {
    // the next slab's loads (none past t_hi) fly during this slab's FMAs;
    // it goes to the other buffer, which every thread finished reading
    // before the barrier that ended the step before
    lst.fetch(l, i0, ni, t0 + kBK, t_hi, tid);
    rst.fetch(r, j0, nj, t0 + kBK, t_hi, tid);
    fma_slab(acc, ls[buf], rs[buf], tx, ty);
    lst.store(ls[buf ^ 1], tid);
    rst.store(rs[buf ^ 1], tid);
    __syncthreads();
  }
}

template <typename LOp, typename ROp>
__global__ void __launch_bounds__(kThreads, 2)
tile_kernel(const LOp l, const ROp r, int ni, int nj, int nt, int tchunk,
            float scale, float* __restrict__ out) {
  __shared__ float ls[2][kBK][kBM + 1];  // two slabs of each: the one the
  __shared__ float rs[2][kBK][kBN + 1];  // FMAs read, the next one staged
  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // block z of the grid contracts t in [z tchunk, (z + 1) tchunk) into
  // output z (the split of #7 / #8's m loop)
  const int t_lo = blockIdx.z * tchunk;
  out += static_cast<size_t>(blockIdx.z) * ni * nj;
  contract(acc, ls, rs, l, r, i0, ni, j0, nj, t_lo, min(nt, t_lo + tchunk));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ty + 16 * i;
    if (gi >= ni) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = j0 + tx + 16 * j;
      if (gj < nj)
        out[static_cast<size_t>(gi) * nj + gj] = scale * acc[i][j];
    }
  }
}

inline dim3 tile_grid(int ni, int nj) {
  return dim3((nj + kBN - 1) / kBN, (ni + kBM - 1) / kBM);
}

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

// out (ni x nj) = gamma sum over m of L(i, t) R(j, t), for #7 and #8: a
// 64 x 64 output tile walks its m rows in one block, and the outputs (r x k,
// n x r) hold few tiles (32 for dA at gemma-2b's q), so the m loop is split
// into msplit chunks of mchunk rows, one grid z each, whose partial sums
// (msplit x ni x nj fp32) sum_partials_kernel adds in a fixed order.
template <typename LOp, typename ROp>
int reduce_m(const LOp l, const ROp r, float* partial, float* out, int ni,
             int nj, int m, int msplit, int mchunk, float gamma,
             cudaStream_t st) {
  dim3 grid = tile_grid(ni, nj);
  grid.z = msplit;
  tile_kernel<<<grid, kThreads, 0, st>>>(l, r, ni, nj, m, mchunk, gamma,
                                         msplit > 1 ? partial : out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || msplit == 1) return static_cast<int>(err);
  sum_partials_kernel<<<(ni * nj + 255) / 256, 256, 0, st>>>(partial, out,
                                                             ni * nj, msplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_da(const float* q, const void* x, float* partial, float* da, int m,
           int k, int r, int msplit, int mchunk, float gamma,
           cudaStream_t st) {
  // out (r x k): L(i, t) = q[t, i] (m x r, across t), R(j, t) = x[t, j]
  return reduce_m(Dense<float, false>{q, r},
                  Dense<T, false>{static_cast<const T*>(x), k}, partial, da,
                  r, k, m, msplit, mchunk, gamma, st);
}

template <typename T>
int bwd_db(const void* g, const float* p, float* partial, float* db, int m,
           int n, int r, int msplit, int mchunk, float gamma,
           cudaStream_t st) {
  // out (n x r): L(i, t) = g[t, i] (m x n, across t), R(j, t) = p[t, j]
  return reduce_m(Dense<T, false>{static_cast<const T*>(g), n},
                  Dense<float, false>{p, r}, partial, db, n, r, m, msplit,
                  mchunk, gamma, st);
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

// q: (m, r) fp32; x of the dtype; da: (r, k) fp32.  The m loop runs in
// msplit chunks of mchunk rows; when msplit > 1, partial is an
// (msplit, r, k) fp32 scratch, else unused.
int lora_bwd_da_launch(const float* q, const void* x, float* partial,
                       float* da, int m, int k, int r, int msplit, int mchunk,
                       float gamma, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_da<float>(q, x, partial, da, m, k, r, msplit, mchunk, gamma,
                         st);
  if (dtype == 1)
    return bwd_da<__nv_bfloat16>(q, x, partial, da, m, k, r, msplit, mchunk,
                                 gamma, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// g of the dtype; p: (m, r) fp32; db: (n, r) fp32; partial (msplit, n, r)
// as for dA.
int lora_bwd_db_launch(const void* g, const float* p, float* partial,
                       float* db, int m, int n, int r, int msplit, int mchunk,
                       float gamma, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_db<float>(g, p, partial, db, m, n, r, msplit, mchunk, gamma,
                         st);
  if (dtype == 1)
    return bwd_db<__nv_bfloat16>(g, p, partial, db, m, n, r, msplit, mchunk,
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
