// Fused LoRA matmul, forward and backward, for Hopper (sm_90a), over an fp
// or a packed frozen base.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/lora_matmul.py that
// make up its jax.custom_vjp's (lora_matmul_vjp, lora_matmul_quant_vjp,
// quant_matmul_vjp):
//   lora_fwd_launch          <- _fwd_kernel       y  = x W + gamma (x A^T) B^T,
//                                                 p  = x A^T (residual)
//   lora_bwd_dx_launch       <- _bwd_dx_kernel    dx = g W^T + gamma (g B) A,
//                                                 q  = g B (residual)
//   lora_bwd_da_launch       <- _bwd_da_kernel    dA = gamma q^T x
//   lora_bwd_db_launch       <- _bwd_db_kernel    dB = gamma g^T p
// and over a packed frozen base (core/quant.py, W = dequant(W)):
//   lora_fwd_quant_launch    <- _fwd_kernel_q     #5 over a packed W
//   lora_bwd_dx_quant_launch <- _bwd_dx_kernel_q  #6 over a packed W
//   quant_matmul_launch      <- _qmm_kernel       y  = x dequant(W)
//   quant_matmul_dx_launch   <- _qmm_dx_kernel    dx = g dequant(W)^T
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
// which they split over blocks.
// The packed forms pay a few integer instructions and a scale load per
// staged W element on top of the fp tiles.
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
// Every main pass is one tiled kernel (tile_kernel) over element views of
// its operands: dense fp32 / bf16 matrices, stored along or across the
// contraction, or a packed W read through its dequantizing loader
// (loaders.cuh) by column (forward) or by row (dx).  Ragged edges are masked
// in the kernels: no shape needs padding, and an int4 W's kq - k padding
// rows are never read.
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

#include "gemv.cuh"
#include "loaders.cuh"

namespace {

using repro_kernels::gemv_partial_kernel;
using repro_kernels::kGvCols;
using repro_kernels::kGvMaxB;
using repro_kernels::kGvWarps;
using repro_kernels::to_f;
using repro_kernels::with_packed_w;

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
// out[i, j] = scale * sum_t L(i, t) R(j, t)
//           + gamma * sum_s L2(i, s) R2(j, s)        (unless R2 is NoRank)
// over an I x J output.  64 x 64 output tile per block, t in steps of 16
// through shared memory, 256 threads with 4 x 4 outputs each (rows
// ty + 16 i, cols tx + 16 j: shared-memory reads are broadcasts or
// conflict-free).  Each operand is an element view (below) that fetches
// element (i, t), with i its output index (a row of L, a column of R) and t
// the contraction index, into registers (fetch) and turns it into fp32
// (cvt), and says how it is stored: kTC when it is contiguous along t.
// Staging maps neighbouring threads to neighbouring addresses in both
// cases.  The contraction loop is inside the block, so no sum crosses
// blocks, except #7 / #8's: their m loop is split over grid z and a second
// kernel adds the parts in a fixed order (below).
//
// Each step's loads would otherwise wait in line behind its FMAs: the next
// slab's loads are issued into registers before the FMAs on the current
// one, converted (a packed W's decode included) and stored to a second
// shared-memory slab after them, so one barrier per step suffices.  The
// launch bound caps a thread at 128 registers, so two blocks share an SM
// and each hides the other's barrier waits (PERF.md).
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

// A packed W (k, n) behind its loader (loaders.cuh) as the right operand:
// by column, R(j, t) = W(t, j), contracting over k (the forward); by row,
// R(j, t) = W(j, t), contracting over n (dx).  Both read W's rows along
// their contiguous n.
template <typename WL>
struct WByCol {
  static constexpr bool kTC = false;
  using Raw = typename WL::Raw;
  WL wl;
  __device__ __forceinline__ Raw fetch(int i, int t) const {
    return wl.fetch(t, i);
  }
  static __device__ __forceinline__ float cvt(Raw v) { return WL::cvt(v); }
};

template <typename WL>
struct WByRow {
  static constexpr bool kTC = true;
  using Raw = typename WL::Raw;
  WL wl;
  __device__ __forceinline__ Raw fetch(int i, int t) const {
    return wl.fetch(i, t);
  }
  static __device__ __forceinline__ float cvt(Raw v) { return WL::cvt(v); }
};

struct NoRank {};  // R2 of a tile with no rank-r term

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

template <typename LOp, typename ROp, typename R2Op>
__global__ void __launch_bounds__(kThreads, 2)
tile_kernel(const LOp l, const ROp r, int ni, int nj, int nt, int tchunk,
            const float* __restrict__ l2, int ldl2, const R2Op r2, int nt2,
            float scale, float gamma, float* __restrict__ out) {
  __shared__ float ls[2][kBK][kBM + 1];  // two slabs of each: the one the
  __shared__ float rs[2][kBK][kBN + 1];  // FMAs read, the next one staged
  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4], acc2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = acc2[i][j] = 0.f;
  // block z of the grid contracts t in [z tchunk, (z + 1) tchunk) into
  // output z (the split of #7 / #8's m loop; one z elsewhere)
  const int t_lo = blockIdx.z * tchunk;
  out += static_cast<size_t>(blockIdx.z) * ni * nj;
  contract(acc, ls, rs, l, r, i0, ni, j0, nj, t_lo, min(nt, t_lo + tchunk));
  if constexpr (!std::is_same<R2Op, NoRank>::value)
    // the rank-r term, after the base product
    contract(acc2, ls, rs, Dense<float, true>{l2, ldl2}, r2, i0, ni, j0, nj,
             0, nt2);
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

inline dim3 tile_grid(int ni, int nj) {
  return dim3((nj + kBN - 1) / kBN, (ni + kBM - 1) / kBM);
}

// y = x W + gamma p B^T over an fp (Dense) or packed (WByCol) W, after the
// xat pre-pass has written p.  L = x (m x k, along t), R = W (n x k);
// L2 = p (m x r), R2 = B (n x r, along s).
template <typename T, typename WOp>
int fwd_tile(const void* x, const WOp w, const void* b, const float* p,
             float* y, int m, int k, int n, int r, float gamma,
             cudaStream_t st) {
  tile_kernel<<<tile_grid(m, n), kThreads, 0, st>>>(
      Dense<T, true>{static_cast<const T*>(x), k}, w, m, n, k, k, p, r,
      Dense<T, true>{static_cast<const T*>(b), r}, r, 1.f, gamma, y);
  return static_cast<int>(cudaGetLastError());
}

// dx = g W^T + gamma q A over an fp or packed (WByRow) W, after the gb
// pre-pass has written q.  L = g (m x n, along t), R = W (k x n, along t);
// L2 = q (m x r), R2 = A (r x k, across s).
template <typename T, typename WOp>
int dx_tile(const void* g, const WOp w, const void* a, const float* q,
            float* dx, int m, int k, int n, int r, float gamma,
            cudaStream_t st) {
  tile_kernel<<<tile_grid(m, k), kThreads, 0, st>>>(
      Dense<T, true>{static_cast<const T*>(g), n}, w, m, k, n, n, q, r,
      Dense<T, false>{static_cast<const T*>(a), k}, r, 1.f, gamma, dx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int xat(const void* x, const void* a, float* p, int m, int k, int r,
        cudaStream_t st) {
  xat_kernel<T><<<dim3(m, (r + kRankWarps - 1) / kRankWarps),
                  kRankWarps * 32, 0, st>>>(static_cast<const T*>(x),
                                            static_cast<const T*>(a), p, m, k,
                                            r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gb(const void* g, const void* b, float* q, int m, int n, int r,
       cudaStream_t st) {
  gb_kernel<T><<<dim3(m, (r + 31) / 32), kRankWarps * 32, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(b), q, m, n, r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd(const void* x, const void* w, const void* a, const void* b, float* p,
        float* y, int m, int k, int n, int r, float gamma, cudaStream_t st) {
  const int err = xat<T>(x, a, p, m, k, r, st);
  if (err != 0) return err;
  return fwd_tile<T>(x, Dense<T, false>{static_cast<const T*>(w), n}, b, p, y,
                     m, k, n, r, gamma, st);
}

template <typename T>
int bwd_dx(const void* g, const void* w, const void* a, const void* b,
           float* q, float* dx, int m, int k, int n, int r, float gamma,
           cudaStream_t st) {
  const int err = gb<T>(g, b, q, m, n, r, st);
  if (err != 0) return err;
  return dx_tile<T>(g, Dense<T, true>{static_cast<const T*>(w), n}, a, q, dx,
                    m, k, n, r, gamma, st);
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
  tile_kernel<<<grid, kThreads, 0, st>>>(l, r, ni, nj, m, mchunk, nullptr, 0,
                                         NoRank{}, 0, gamma, 0.f,
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
// The same tiles with W behind an int8 / int4 loader (loaders.cuh), which
// forms each element as core/quant.dequantize does.  x's columns (and W's
// rows) are masked at the logical k, below the padded kq of an int4 W; dx's
// columns likewise.

// #9: the xat pre-pass, then the forward tile over W by column.
template <typename T>
int fwd_quant(const void* x, const void* wd, const float* ws, const void* a,
              const void* b, float* p, float* y, int m, int k, int n, int r,
              float gamma, int bits, int group, int bf16w, cudaStream_t st) {
  const int err = xat<T>(x, a, p, m, k, r, st);
  if (err != 0) return err;
  return with_packed_w(wd, ws, n, bits, group, bf16w, [&](auto wl) {
    return fwd_tile<T>(x, WByCol<decltype(wl)>{wl}, b, p, y, m, k, n, r,
                       gamma, st);
  });
}

// #10: the gb pre-pass, then the dx tile over W by row.
template <typename T>
int bwd_dx_quant(const void* g, const void* wd, const float* ws,
                 const void* a, const void* b, float* q, float* dx, int m,
                 int k, int n, int r, float gamma, int bits, int group,
                 int bf16w, cudaStream_t st) {
  const int err = gb<T>(g, b, q, m, n, r, st);
  if (err != 0) return err;
  return with_packed_w(wd, ws, n, bits, group, bf16w, [&](auto wl) {
    return dx_tile<T>(g, WByRow<decltype(wl)>{wl}, a, q, dx, m, k, n, r,
                      gamma, st);
  });
}

// #12: dx = g dequant(W)^T, the dx tile with no rank term.
template <typename T>
int qmm_dx(const void* g, const void* wd, const float* ws, float* dx, int m,
           int k, int n, int bits, int group, int bf16w, cudaStream_t st) {
  return with_packed_w(wd, ws, n, bits, group, bf16w, [&](auto wl) {
    tile_kernel<<<tile_grid(m, k), kThreads, 0, st>>>(
        Dense<T, true>{static_cast<const T*>(g), n},
        WByRow<decltype(wl)>{wl}, m, k, n, n, nullptr, 0, NoRank{}, 0, 1.f,
        0.f, dx);
    return static_cast<int>(cudaGetLastError());
  });
}

// #11: y = x dequant(W).  For m > kGvMaxB rows (prefills, training) the
// forward tile over W by column with no rank term.  Decode form (m <=
// kGvMaxB): the tile would loop over all of k in 16-row steps for every
// output tile, bound by that loop's latency (about 3 ms for an int4 w_down
// at m = 4 on an H100, PERF.md); the split-k GEMV of gemv.cuh reads each
// packed W element once and spreads k over blocks, then
// sum_partials_kernel adds the ksplit partials.
template <typename T, typename WL>
int qmm_launch(const T* x, const WL wl, float* partial, float* y, int m,
               int k, int n, int ksplit, int kchunk, cudaStream_t st) {
  if (m > kGvMaxB) {
    tile_kernel<<<tile_grid(m, n), kThreads, 0, st>>>(
        Dense<T, true>{x, k}, WByCol<WL>{wl}, m, n, k, k, nullptr, 0,
        NoRank{}, 0, 1.f, 0.f, y);
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
        int group, int bf16w, cudaStream_t st) {
  return with_packed_w(wd, ws, n, bits, group, bf16w, [&](auto wl) {
    return qmm_launch<T>(static_cast<const T*>(x), wl, partial, y, m, k, n,
                         ksplit, kchunk, st);
  });
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
// #11: y (m, n).  When m <= 8 (the decode form) partial is a (ksplit, m, n)
// fp32 scratch and the k range splits into ksplit chunks of kchunk;
// otherwise partial, ksplit and kchunk are unused.
int quant_matmul_launch(const void* x, const void* wd, const float* ws,
                        float* partial, float* y, int m, int k, int n,
                        int ksplit, int kchunk, int bits, int group, int bf16w,
                        int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return qmm<float>(x, wd, ws, partial, y, m, k, n, ksplit, kchunk, bits,
                      group, bf16w, st);
  if (dtype == 1)
    return qmm<__nv_bfloat16>(x, wd, ws, partial, y, m, k, n, ksplit, kchunk,
                              bits, group, bf16w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// #9: p (m, r) fp32, written (the residual, or scratch); y (m, n).
int lora_fwd_quant_launch(const void* x, const void* wd, const float* ws,
                          const void* a, const void* b, float* p, float* y,
                          int m, int k, int n, int r, float gamma, int bits,
                          int group, int bf16w, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_quant<float>(x, wd, ws, a, b, p, y, m, k, n, r, gamma, bits,
                            group, bf16w, st);
  if (dtype == 1)
    return fwd_quant<__nv_bfloat16>(x, wd, ws, a, b, p, y, m, k, n, r, gamma,
                                    bits, group, bf16w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// #10: q (m, r) fp32, written; dx (m, k).
int lora_bwd_dx_quant_launch(const void* g, const void* wd, const float* ws,
                             const void* a, const void* b, float* q, float* dx,
                             int m, int k, int n, int r, float gamma, int bits,
                             int group, int bf16w, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_dx_quant<float>(g, wd, ws, a, b, q, dx, m, k, n, r, gamma, bits,
                               group, bf16w, st);
  if (dtype == 1)
    return bwd_dx_quant<__nv_bfloat16>(g, wd, ws, a, b, q, dx, m, k, n, r,
                                       gamma, bits, group, bf16w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// #12: dx (m, k).
int quant_matmul_dx_launch(const void* g, const void* wd, const float* ws,
                           float* dx, int m, int k, int n, int bits, int group,
                           int bf16w, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return qmm_dx<float>(g, wd, ws, dx, m, k, n, bits, group, bf16w, st);
  if (dtype == 1)
    return qmm_dx<__nv_bfloat16>(g, wd, ws, dx, m, k, n, bits, group, bf16w,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
