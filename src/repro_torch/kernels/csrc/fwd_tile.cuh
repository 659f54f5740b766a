// The rank-fused forward tile, for Hopper (sm_90a): one kernel body for
// eight of the TPU kernels of src/repro/kernels/:
//   bgmv.cu        #2 _bgmv_kernel (bgmv.py:59), #3 _bgmv_kernel_q (:224):
//                  the BGMV prefill over an fp or packed W;
//   lora_matmul.cu #5 _fwd_kernel (lora_matmul.py:55), #9 _fwd_kernel_q
//                  (:345): the LoRA forward; #11 _qmm_kernel (:514) at m > 8
//                  rows: the packed GEMM, no rank term;
//   dense_dx.cu    #6 _bwd_dx_kernel (:147): dx = g W^T + gamma (g B) A over
//                  a dense W;
//   packed_dx.cu   #12 _qmm_dx_kernel (:544): dx = g dequant(W)^T, no rank
//                  term; #10 _bwd_dx_kernel_q (:414): #6 over a packed W.
//                  #6 and #10 swap the roles of the forward's operands
//                  (dx_rank_fused, below).
//
//   p[i, s]   = sum_t x[i, t] A_row(i)[s, t]                  (pre-pass)
//   out[i, j] = sum_t x[i, t] W(t, j) + gamma sum_s p[i, s] B_row(i)[j, s]
//
// with x (m, k) fp32 or bf16; W (k, n) of x's type or packed int8 / int4
// (loaders.cuh's layout and products); A_row(i) = A + id(i) a_stride (r, k),
// B_row(i) = B + id(i) b_stride (n, r), id(i) = ids[i / s] or i / s when ids
// is null (a bank: #2 / #3, gamma 1 since the bank folds each tenant's scale
// into its B), or one A and B with stride 0 and s = m (#5 / #9).  p and out
// are fp32; p is the residual the LoRA backward reuses.
//
// What bounds it on an H100 at the paths' shapes (m = 512; k = 2048 or
// 4096; n = 2048 / 4096 (q, wx, wy), 256 (v) or 16384 (the MLP); r = 8 or
// 64): operations, fp32 FMA on the CUDA cores (67 TFLOP/s; no TF32, so the
// fp32 bounds hold).  The 64 x 64 tiles this body replaces lost 2.4-9x to
// torch.matmul:
//   - 32 blocks on 132 SMs at n = 256, each walking all of k.  Here a
//     128 x 128 tile (128 x 64 for the pre-pass) walks one chunk of the
//     contraction, grid z picks the chunk, and the chunks are planned on
//     the host (kernels/common.py fwd_split) so that tiles x chunks fill the
//     SMs once.  Each chunk writes an fp32 partial; fwd_sum_kernel adds
//     them in a fixed order (no atomics: a run repeats bit for bit).
//   - 2 FMAs per shared-memory load.  Here each thread owns 8 x 8 outputs
//     (8 x 4 in the pre-pass), reads x and W as float4 (16 loads per 256
//     FMAs), from a 3-stage ring of slabs that cp.async (16-byte,
//     .cg) fills for fp32 operands, so the next slabs' loads fly under the
//     current one's FMAs; other operands are loaded into registers before
//     the FMAs and written after them.
//   - a packed W decoded element by element.  Here one 32-bit load brings 4
//     int8 columns (scales loaded once per tile) or 4 int4 columns of 2 rows
//     (one scale row per slab: a slab of 16 rows never straddles a group of
//     16 or more).  Each element is still float(q) * scale, rounded to bf16
//     for a base packed from bf16 weights, so kernel and plain version differ
//     only in the order of their sums.
//   - a pre-pass of one warp per (row, j) that read x r times.  Here the
//     pre-pass is this same body with no base term and A^T as the right
//     operand: a block stages 128 x rows and 64 rank rows of A per slab.
//   - a rank epilogue of r loads of B from L2 per output.  Here the rank
//     term is the contraction's tail: p rows and B rows (scaled by gamma) go
//     through the same ring and micro-kernel, one pass per request in the
//     tile (rows of other requests are masked to 0), as slabs r of the
//     chunked range [0, roundup(k, 16) + r).
//   - #12, #10 and #6 contract along W's contiguous n, so the by-column
//     stagers cannot serve them.  Here g goes through Rows and W through
//     RowsInt8 / RowsInt4, which stage element (t, j) = dequant(W)(j, t) 4
//     n of two neighbouring rows a thread (a 32-bit word of each row for
//     int8, the byte row both share for int4), convert without I2F and
//     store transposed as float2, or (a dense W) ColsT, 4 n of one row a
//     thread stored transposed; the host splits n (kernels/common.py
//     dx_plan) where the (m, k) tiles leave SMs idle.  The q = g B of #10
//     and #6 is the pre-pass with B row-major (ColsDense) as the right
//     operand, and gamma q A the tail, A row-major scaled by gamma as it is
//     staged.  #6 ran on a 64 x 64 tile with a one-warp-per-row q pre-pass
//     at 2.44x torch.matmul (PERF.md).
// Ragged edges are masked (nothing is padded; an int4 W's kq - k rows are
// never read).  The vector paths need k, n, r multiples of 4 and aligned
// operands (and, by column, int4 groups of 16 rows or more); the host picks
// the scalar path otherwise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "loaders.cuh"

namespace repro_kernels {

constexpr int kFwdBM = 128;      // output rows per block
constexpr int kFwdBK = 16;       // contraction rows per slab
constexpr int kFwdThreads = 256;
constexpr int kFwdStages = 3;    // slabs in the shared-memory ring
constexpr int kFwdMainBN = 128;  // output columns per block: main pass
constexpr int kFwdPreBN = 64;    //                            pre-pass
constexpr int kXLd = kFwdBK + 4;  // row stride of an x slab (floats)

// internal linkage: each translation unit that includes this header
// instantiates and registers its own copy of each kernel
namespace {

template <int kBN>
struct Geo {
  static constexpr int kNC = kBN / 64;  // float4 column groups per thread
  static constexpr int kWLd = kBN + 4;  // row stride of a W slab (floats)
  static constexpr int kXFloats = kFwdBM * kXLd;
  static constexpr int kStage = kXFloats + kFwdBK * kWLd;
  static constexpr size_t kSmem = sizeof(float) * kStage * kFwdStages;
};

// --------------------------------------------------------------- stagers
// A stager moves one slab of an operand into a stage of the ring as fp32:
// fetch(t0, tlim, buf) starts the slab [t0, t0 + kFwdBK) (cp.async straight
// into buf, or loads into registers) and store(buf) finishes a register
// fetch (convert, dequantize, write).  Elements outside the operand are 0.
// Left operands (x, p) go to buf[row][t] with row stride kXLd; right
// operands (W, B^T, A^T) to buf[t][col] with row stride kBN + 4.

// Rows [lo, hi) of an (., ld) matrix along t: x, or the residual p.
template <typename E, bool kVec>
struct Rows {
  static constexpr bool kAsync = kVec && std::is_same<E, float>::value;
  static constexpr int kW = kVec ? 4 : 1;           // elements per load
  static constexpr int kPerRow = kFwdBK / kW;       // loads per slab row
  static constexpr int kN = kFwdBM * kPerRow / kFwdThreads;
  const E* p;
  int ld;
  int m0, lo, hi;
  typename Vec4<E>::U u[kN];
  E v[kN];

  __device__ __forceinline__ void rows(int m0_, int lo_, int hi_) {
    m0 = m0_;
    lo = lo_;
    hi = hi_;
  }
  __device__ __forceinline__ void fetch(int t0, int tlim, float* buf) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int idx = threadIdx.x + e * kFwdThreads;
      const int row = idx / kPerRow, c = (idx % kPerRow) * kW;
      const int i = m0 + row, t = t0 + c;
      const bool in = i >= lo && i < hi && t < tlim;
      const E* src = in ? p + static_cast<size_t>(i) * ld + t : p;
      if constexpr (kAsync)
        cp_async<16>(buf + row * kXLd + c, src, in);
      else if constexpr (kVec)
        u[e] = ld4(src, in);
      else
        v[e] = in ? ldg(src) : E(0.f);
    }
  }
  __device__ __forceinline__ void store(float* buf) const {
    if constexpr (!kAsync) {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const int idx = threadIdx.x + e * kFwdThreads;
        const int row = idx / kPerRow, c = (idx % kPerRow) * kW;
        if constexpr (kVec)
          *reinterpret_cast<float4*>(buf + row * kXLd + c) = as_f4(u[e]);
        else
          buf[row * kXLd + c] = to_f(v[e]);
      }
    }
  }
};

// A dense row-major (t, j) operand with leading dimension ld, columns [n0,
// nlim): a W (k, n) of #2 / #5; B (n, r) as the right operand of #10's
// pre-pass; and, kScaled, gamma A (r, k) as #10's rank tail.  One operand
// for every request (adapter() is a no-op).  A scaled operand stages through
// registers (cp.async copies bytes as they are).
template <int kBN, typename T, bool kVec_, bool kScaled = false>
struct ColsDense {
  static constexpr bool kVec = kVec_;
  static constexpr bool kAsync =
      kVec && std::is_same<T, float>::value && !kScaled;
  static constexpr int kW = kVec ? 4 : 1;
  static constexpr int kPerRow = kBN / kW;
  static constexpr int kN = kFwdBK * kPerRow / kFwdThreads;
  static constexpr int kLd = kBN + 4;
  const T* p;
  int ld, nlim;
  float scale = 1.f;  // read only when kScaled
  int n0;
  typename Vec4<T>::U u[kN];
  T v[kN];

  __device__ __forceinline__ void cols(int n0_) { n0 = n0_; }
  __device__ __forceinline__ void adapter(int) {}
  __device__ __forceinline__ void fetch(int t0, int tlim, float* buf) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int idx = threadIdx.x + e * kFwdThreads;
      const int tt = idx / kPerRow, c = (idx % kPerRow) * kW;
      const int t = t0 + tt, j = n0 + c;
      const bool in = t < tlim && j < nlim;
      const T* src = in ? p + static_cast<size_t>(t) * ld + j : p;
      if constexpr (kAsync)
        cp_async<16>(buf + tt * kLd + c, src, in);
      else if constexpr (kVec)
        u[e] = ld4(src, in);
      else
        v[e] = in ? ldg(src) : T(0.f);
    }
  }
  __device__ __forceinline__ void store(float* buf) const {
    if constexpr (!kAsync) {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const int idx = threadIdx.x + e * kFwdThreads;
        const int tt = idx / kPerRow, c = (idx % kPerRow) * kW;
        if constexpr (kVec) {
          float4 f = as_f4(u[e]);
          if constexpr (kScaled)
            f = make_float4(scale * f.x, scale * f.y, scale * f.z,
                            scale * f.w);
          *reinterpret_cast<float4*>(buf + tt * kLd + c) = f;
        } else {
          buf[tt * kLd + c] = kScaled ? scale * to_f(v[e]) : to_f(v[e]);
        }
      }
    }
  }
};

// A packed int8 W (k, n) with per-column scales.  Vector path: one 32-bit
// load is 4 columns of one row; a thread's 4 columns are the same in every
// slab, so their scales are loaded once per tile.  Scalar path: loaders.cuh
// element by element.
template <int kBN, bool kBf16, bool kVec_>
struct ColsInt8 {
  static constexpr bool kVec = kVec_;
  static constexpr int kPerRow = kVec ? kBN / 4 : kBN;
  static constexpr int kN = kFwdBK * kPerRow / kFwdThreads;
  static constexpr int kLd = kBN + 4;
  static_assert(kFwdThreads % kPerRow == 0, "fixed columns per thread");
  Int8W<kBf16> wl;
  int n0;
  float4 sc;
  int w[kN];
  typename Int8W<kBf16>::Raw raw[kN];
  bool in[kN];

  __device__ __forceinline__ void cols(int n0_) {
    n0 = n0_;
    if constexpr (kVec) {
      const int j = n0 + (threadIdx.x % kPerRow) * 4;
      sc = j < wl.n ? __ldg(reinterpret_cast<const float4*>(wl.s + j))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void fetch(int t0, int tlim, float*) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int idx = threadIdx.x + e * kFwdThreads;
      const int tt = idx / kPerRow;
      const int j = n0 + (idx % kPerRow) * (kVec ? 4 : 1);
      const int t = t0 + tt;
      in[e] = t < tlim && j < wl.n;
      if constexpr (kVec)
        w[e] = in[e] ? __ldg(reinterpret_cast<const int*>(
                           wl.d + static_cast<size_t>(t) * wl.n + j))
                     : 0;
      else if (in[e])
        raw[e] = wl.fetch(t, j);
    }
  }
  __device__ __forceinline__ void store(float* buf) const {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int idx = threadIdx.x + e * kFwdThreads;
      const int tt = idx / kPerRow;
      if constexpr (kVec) {
        const int c = (idx % kPerRow) * 4;
        // byte u of the word, sign-extended
        const auto q = [&](int u) {
          return static_cast<float>(static_cast<int>(
                     static_cast<unsigned>(w[e]) << (24 - 8 * u)) >> 24);
        };
        *reinterpret_cast<float4*>(buf + tt * kLd + c) = make_float4(
            dequant<kBf16>(q(0), sc.x), dequant<kBf16>(q(1), sc.y),
            dequant<kBf16>(q(2), sc.z), dequant<kBf16>(q(3), sc.w));
      } else {
        buf[tt * kLd + idx % kPerRow] =
            in[e] ? Int8W<kBf16>::cvt(raw[e]) : 0.f;
      }
    }
  }
};

// A packed int4 W: uint8 data (kq / 2, n), two rows a byte, group scales
// (kq / group, n).  Vector path: one 32-bit load is 4 columns of 2 rows, and
// the slab's one scale row (group % kFwdBK == 0) is loaded with it.
template <int kBN, bool kBf16, bool kVec_>
struct ColsInt4 {
  static constexpr bool kVec = kVec_;
  static constexpr int kPerRow = kVec ? kBN / 4 : kBN;
  // vector: 8 byte rows a slab; scalar: 16 element rows
  static constexpr int kRows = kVec ? kFwdBK / 2 : kFwdBK;
  static constexpr int kN = (kRows * kPerRow + kFwdThreads - 1) / kFwdThreads;
  static constexpr int kLd = kBN + 4;
  Int4W<kBf16> wl;
  int n0;
  int w[kN];
  float4 sc[kN];
  bool hi_in[kN];  // the word's odd row lies below tlim
  typename Int4W<kBf16>::Raw raw[kN];
  bool in[kN];

  __device__ __forceinline__ void cols(int n0_) { n0 = n0_; }
  __device__ __forceinline__ void fetch(int t0, int tlim, float*) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int idx = threadIdx.x + e * kFwdThreads;
      const int rr = idx / kPerRow;
      const int j = n0 + (idx % kPerRow) * (kVec ? 4 : 1);
      if constexpr (kVec) {
        const int t = t0 + 2 * rr;
        const bool ok = rr < kRows && t < tlim && j < wl.n;
        hi_in[e] = t + 1 < tlim;
        w[e] = ok ? __ldg(reinterpret_cast<const int*>(
                        wl.d + static_cast<size_t>(t >> 1) * wl.n + j))
                  : 0;
        sc[e] = ok ? __ldg(reinterpret_cast<const float4*>(
                         wl.s + static_cast<size_t>(t0 >> wl.group_shift) *
                                    wl.n + j))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const int t = t0 + rr;
        in[e] = t < tlim && j < wl.n;
        if (in[e]) raw[e] = wl.fetch(t, j);
      }
    }
  }
  __device__ __forceinline__ void store(float* buf) const {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int idx = threadIdx.x + e * kFwdThreads;
      const int rr = idx / kPerRow;
      if constexpr (kVec) {
        if (rr >= kRows) continue;
        const int c = (idx % kPerRow) * 4;
        // nibble h (0: even row, 1: odd row) of byte u, sign-extended
        const auto q = [&](int u, int h) {
          int v = (w[e] >> (8 * u + 4 * h)) & 0xF;
          return static_cast<float>(v - 2 * (v & 8));
        };
        const float s[4] = {sc[e].x, sc[e].y, sc[e].z, sc[e].w};
        float lo[4], hi[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          lo[u] = dequant<kBf16>(q(u, 0), s[u]);
          hi[u] = hi_in[e] ? dequant<kBf16>(q(u, 1), s[u]) : 0.f;
        }
        *reinterpret_cast<float4*>(buf + (2 * rr) * kLd + c) =
            make_float4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<float4*>(buf + (2 * rr + 1) * kLd + c) =
            make_float4(hi[0], hi[1], hi[2], hi[3]);
      } else {
        buf[rr * kLd + idx % kPerRow] =
            in[e] ? Int4W<kBf16>::cvt(raw[e]) : 0.f;
      }
    }
  }
};

// The transpose of a (cols, ld) matrix per adapter, scaled: element
// (t, j) = scale * q[j * ld + t], q = base + id * stride, columns [n0,
// nlim).  B^T (t = rank index, ld = r) in the main pass, scaled by gamma;
// A^T (t along k, ld = k) in the pre-pass; and a dense W (k, n) read by row
// for #6's dx = g W^T (ld = n, nlim = k, stride 0, scale 1, q = W): 4 lanes
// read 64 contiguous bytes of a row.  Its transposed stores are 2-way
// bank-conflicted (a warp's 8 j x 4 t, row stride kBN + 4); a stager on
// RowsInt8's pattern (4 t of two rows a thread, stored as float2,
// conflict-free) ran #6's main tile 1.8% slower on an H100 (PERF.md): its
// 16-byte loads from 64 rows a warp cost more than the conflicts.
template <int kBN, typename T, bool kVec_>
struct ColsT {
  static constexpr bool kVec = kVec_;
  static constexpr int kW = kVec ? 4 : 1;
  static constexpr int kPerCol = kFwdBK / kW;  // loads per column per slab
  static constexpr int kN = kBN * kPerCol / kFwdThreads;
  static constexpr int kLd = kBN + 4;
  const T* base;
  int ld, nlim;
  size_t stride;
  float scale;
  const T* q;
  int n0;
  typename Vec4<T>::U u[kN];
  T v[kN];

  __device__ __forceinline__ void cols(int n0_) { n0 = n0_; }
  __device__ __forceinline__ void adapter(int id) {
    q = base + static_cast<size_t>(id) * stride;
  }
  __device__ __forceinline__ void fetch(int t0, int tlim, float*) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int idx = threadIdx.x + e * kFwdThreads;
      const int jj = idx / kPerCol, c = (idx % kPerCol) * kW;
      const int j = n0 + jj, t = t0 + c;
      const bool in = j < nlim && t < tlim;
      const T* src = in ? q + static_cast<size_t>(j) * ld + t : q;
      if constexpr (kVec)
        u[e] = ld4(src, in);
      else
        v[e] = in ? ldg(src) : T(0.f);
    }
  }
  __device__ __forceinline__ void store(float* buf) const {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int idx = threadIdx.x + e * kFwdThreads;
      const int jj = idx / kPerCol, c = (idx % kPerCol) * kW;
      if constexpr (kVec) {
        const float4 f = as_f4(u[e]);
        buf[(c + 0) * kLd + jj] = scale * f.x;
        buf[(c + 1) * kLd + jj] = scale * f.y;
        buf[(c + 2) * kLd + jj] = scale * f.z;
        buf[(c + 3) * kLd + jj] = scale * f.w;
      } else {
        buf[c * kLd + jj] = scale * to_f(v[e]);
      }
    }
  }
};

// A packed W (k, n) read by row, for dx = g dequant(W)^T (#12): element
// (t, j) = dequant(W)(j, t), with j along the output (W's row, k, columns
// [n0, nlim = k)) and t along the contraction (W's contiguous n).  Vector
// path: a thread stages 4 consecutive t of two neighbouring rows j, j + 1
// (one 32-bit load of each row for int8, one load of the byte row both
// share for int4) with one float4 of scales, and stores them transposed as
// 4 float2 (buf[t][j, j + 1], row stride kBN + 4): a warp's 32 lanes take
// 64 consecutive j at one t, so each store is the 2 wavefronts 256 bytes
// need.  The integers become floats without a conversion instruction
// (loaders.cuh s8_float / s4_float).  Each element is then still float(q) *
// scale, rounded to bf16 for a base packed from bf16 weights, as
// loaders.cuh forms it.
// Scalar path: loaders.cuh element by element, for shapes off the vector
// conditions.  Columns at or past k (an odd k's last row, an int4 W's kq -
// k padding rows) are never stored as anything but 0.

// int8, per-n scales: row j's word and row j + 1's share s[t, t + 4).
template <int kBN, bool kBf16, bool kVec_>
struct RowsInt8 {
  static constexpr bool kVec = kVec_;
  static constexpr int kPer = kVec ? kBN / 2 : kBN;       // loads per t step
  static constexpr int kTq = kVec ? kFwdBK / 4 : kFwdBK;  // t steps a slab
  static constexpr int kN = kPer * kTq / kFwdThreads;
  static constexpr int kLd = kBN + 4;
  Int8W<kBf16> wl;  // its n: the contraction length
  int nlim;         // k
  int n0;
  unsigned w[kN], w1[kN];  // rows j and j + 1
  float4 sc[kN];
  typename Int8W<kBf16>::Raw raw[kN];
  bool in[kN];

  __device__ __forceinline__ void cols(int n0_) { n0 = n0_; }
  __device__ __forceinline__ void fetch(int t0, int tlim, float*) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int idx = threadIdx.x + e * kFwdThreads;
      if constexpr (kVec) {
        const int j = n0 + 2 * (idx % kPer), t = t0 + (idx / kPer) * 4;
        in[e] = j < nlim && t < tlim;
        const int8_t* row = wl.d + static_cast<size_t>(j) * wl.n + t;
        w[e] = in[e] ? __ldg(reinterpret_cast<const unsigned*>(row)) : 0u;
        w1[e] = in[e] && j + 1 < nlim
                    ? __ldg(reinterpret_cast<const unsigned*>(row + wl.n))
                    : 0u;
        sc[e] = in[e] ? __ldg(reinterpret_cast<const float4*>(wl.s + t))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const int j = n0 + idx % kBN, t = t0 + idx / kBN;
        in[e] = j < nlim && t < tlim;
        if (in[e]) raw[e] = wl.fetch(j, t);
      }
    }
  }
  __device__ __forceinline__ void store(float* buf) const {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int idx = threadIdx.x + e * kFwdThreads;
      if constexpr (kVec) {
        const int jj = 2 * (idx % kPer), tt = (idx / kPer) * 4;
        const unsigned x0 = w[e] ^ 0x80808080u, x1 = w1[e] ^ 0x80808080u;
        const float s[4] = {sc[e].x, sc[e].y, sc[e].z, sc[e].w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          *reinterpret_cast<float2*>(buf + (tt + u) * kLd + jj) =
              make_float2(dequant<kBf16>(s8_float(x0, u), s[u]),
                          dequant<kBf16>(s8_float(x1, u), s[u]));
      } else {
        buf[(idx / kBN) * kLd + idx % kBN] =
            in[e] ? Int8W<kBf16>::cvt(raw[e]) : 0.f;
      }
    }
  }
};

// int4, two rows a byte (j even: row j the low nibble, j + 1 the high),
// scales per (group of rows of k, n): the tile's 128 columns straddle
// groups of k, so each word indexes its own scale row, s[j >> shift][t, t +
// 4) (a group of 2 or more rows holds both rows of a byte).
template <int kBN, bool kBf16, bool kVec_>
struct RowsInt4 {
  static constexpr bool kVec = kVec_;
  static constexpr int kPer = kVec ? kBN / 2 : kBN;       // loads per t step
  static constexpr int kTq = kVec ? kFwdBK / 4 : kFwdBK;  // t steps a slab
  static constexpr int kN = kPer * kTq / kFwdThreads;
  static constexpr int kLd = kBN + 4;
  Int4W<kBf16> wl;  // its n: the contraction length
  int nlim;         // k
  int n0;
  unsigned w[kN];
  float4 sc[kN];
  bool hi_in[kN];  // row j + 1 lies below k
  typename Int4W<kBf16>::Raw raw[kN];
  bool in[kN];

  __device__ __forceinline__ void cols(int n0_) { n0 = n0_; }
  __device__ __forceinline__ void fetch(int t0, int tlim, float*) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int idx = threadIdx.x + e * kFwdThreads;
      if constexpr (kVec) {
        const int j = n0 + 2 * (idx % kPer), t = t0 + (idx / kPer) * 4;
        in[e] = j < nlim && t < tlim;
        hi_in[e] = j + 1 < nlim;
        w[e] = in[e] ? __ldg(reinterpret_cast<const unsigned*>(
                           wl.d + static_cast<size_t>(j >> 1) * wl.n + t))
                     : 0u;
        sc[e] = in[e] ? __ldg(reinterpret_cast<const float4*>(
                            wl.s + static_cast<size_t>(j >> wl.group_shift) *
                                       wl.n + t))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const int j = n0 + idx % kBN, t = t0 + idx / kBN;
        in[e] = j < nlim && t < tlim;
        if (in[e]) raw[e] = wl.fetch(j, t);
      }
    }
  }
  __device__ __forceinline__ void store(float* buf) const {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int idx = threadIdx.x + e * kFwdThreads;
      if constexpr (kVec) {
        const int jj = 2 * (idx % kPer), tt = (idx / kPer) * 4;
        const unsigned x = w[e] ^ 0x88888888u;
        const unsigned lo = x & 0x0F0F0F0Fu, hi = (x >> 4) & 0x0F0F0F0Fu;
        const float s[4] = {sc[e].x, sc[e].y, sc[e].z, sc[e].w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          *reinterpret_cast<float2*>(buf + (tt + u) * kLd + jj) =
              make_float2(dequant<kBf16>(s4_float(lo, u), s[u]),
                          hi_in[e] ? dequant<kBf16>(s4_float(hi, u), s[u])
                                   : 0.f);
      } else {
        buf[(idx / kBN) * kLd + idx % kBN] =
            in[e] ? Int4W<kBf16>::cvt(raw[e]) : 0.f;
      }
    }
  }
};

// The pre-pass has no base term.
struct NoStage {
  __device__ __forceinline__ void rows(int, int, int) {}
  __device__ __forceinline__ void cols(int) {}
  __device__ __forceinline__ void fetch(int, int, float*) {}
  __device__ __forceinline__ void store(float*) const {}
};

// ----------------------------------------------------------- micro-kernel
// acc[i][g * 4 + c] += sum over the slab of xs[ty + 16 i][t] *
// ws[t][g * 64 + tx * 4 + c], t in steps of 4: 8 float4 loads of x, then
// per t kNC float4 loads of W (16 loads per 256 FMAs at kBN = 128).  A warp
// spans 4 rows (ty) and 8 column quads (tx): its x loads hit 4 distinct
// 16-byte words in distinct banks (row stride 20 floats) and its W loads
// one 128-byte line.
template <int kBN>
__device__ __forceinline__ void micro(float (&acc)[8][Geo<kBN>::kNC * 4],
                                      const float* xs, const float* ws,
                                      int tx, int ty) {
  constexpr int kNC = Geo<kBN>::kNC, kWLd = Geo<kBN>::kWLd;
#pragma unroll
  for (int kk = 0; kk < kFwdBK; kk += 4) {
    float4 xv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xv[i] = *reinterpret_cast<const float4*>(xs + (ty + 16 * i) * kXLd + kk);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float4 wv[kNC];
#pragma unroll
      for (int g = 0; g < kNC; ++g)
        wv[g] = *reinterpret_cast<const float4*>(ws + (kk + h) * kWLd +
                                                 g * 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xi = h == 0   ? xv[i].x
                         : h == 1 ? xv[i].y
                         : h == 2 ? xv[i].z
                                  : xv[i].w;
#pragma unroll
        for (int g = 0; g < kNC; ++g) {
          acc[i][g * 4 + 0] = fmaf(xi, wv[g].x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(xi, wv[g].y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(xi, wv[g].z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(xi, wv[g].w, acc[i][g * 4 + 3]);
        }
      }
    }
  }
}

// Contract t in [t_lo, t_hi) of the left stager xs against the right
// stager ws into acc, through the kFwdStages ring: slab it + kFwdStages - 1
// is requested before slab it's FMAs and (register stagers) written after
// them, into the stage slab it - 1 used; one barrier per slab.
template <int kBN, class XS, class WS>
__device__ __forceinline__ void mainloop(float (&acc)[8][Geo<kBN>::kNC * 4],
                                         float* smem, XS& xs, WS& ws,
                                         int t_lo, int t_hi, int tx, int ty) {
  using G = Geo<kBN>;
  const int nslab = (t_hi - t_lo + kFwdBK - 1) / kFwdBK;
  __syncthreads();  // every thread is done with the ring's last use
#pragma unroll
  for (int st = 0; st < kFwdStages - 1; ++st) {
    if (st < nslab) {
      float* xb = smem + st * G::kStage;
      xs.fetch(t_lo + st * kFwdBK, t_hi, xb);
      ws.fetch(t_lo + st * kFwdBK, t_hi, xb + G::kXFloats);
      xs.store(xb);
      ws.store(xb + G::kXFloats);
    }
    cp_async_commit();
  }
  int rd = 0, wr = kFwdStages - 1;
  for (int it = 0; it < nslab; ++it) {
    cp_async_wait<kFwdStages - 2>();
    __syncthreads();
    float* nb = smem + wr * G::kStage;
    const bool more = it + kFwdStages - 1 < nslab;
    if (more) {
      const int t0 = t_lo + (it + kFwdStages - 1) * kFwdBK;
      xs.fetch(t0, t_hi, nb);
      ws.fetch(t0, t_hi, nb + G::kXFloats);
    }
    cp_async_commit();
    const float* cb = smem + rd * G::kStage;
    micro<kBN>(acc, cb, cb + G::kXFloats, tx, ty);
    if (more) {
      xs.store(nb);
      ws.store(nb + G::kXFloats);
    }
    rd = rd + 1 == kFwdStages ? 0 : rd + 1;
    wr = wr + 1 == kFwdStages ? 0 : wr + 1;
  }
  cp_async_wait<0>();
}

// --------------------------------------------------------------- kernels
struct FwdShape {
  int m, n;    // output rows and columns
  int kbase;   // base contraction length (0: none, the pre-pass)
  int r;       // rank contraction length
  int vchunk;  // grid z contracts [z vchunk, (z + 1) vchunk) of the range
               // [0, roundup(kbase, kFwdBK) + r): base slabs, then rank ones
  int s;       // rows per request
  const int* ids;  // adapter of request q: ids[q], or q when null
};

// One block per SM, as the host's plan fills the card: up to 255 registers
// a thread hold the 8 x 8 accumulators, the fragments and the register
// stagers' slabs without spilling (capped at 128 for two blocks per SM, the
// fp32 tile spilled 148 bytes and ran 12% slower on an H100, PERF.md).
template <int kBN, class XS, class WS, class PS, class BS>
__global__ void __launch_bounds__(kFwdThreads, 1)
fwd_kernel(const XS xs0, const WS ws0, const PS ps0, const BS bs0,
           const FwdShape sh, float* __restrict__ out) {
  constexpr int kNC = Geo<kBN>::kNC;
  extern __shared__ float4 fwd_smem4[];
  float* smem = reinterpret_cast<float*>(fwd_smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int m0 = blockIdx.y * kFwdBM, n0 = blockIdx.x * kBN;
  const int mhi = min(sh.m, m0 + kFwdBM);
  float acc[8][kNC * 4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kNC * 4; ++j) acc[i][j] = 0.f;

  const int kpad = (sh.kbase + kFwdBK - 1) / kFwdBK * kFwdBK;
  const int v_lo = blockIdx.z * sh.vchunk;
  const int v_hi = min(kpad + sh.r, v_lo + sh.vchunk);
  if (v_lo < sh.kbase) {  // the base term: x W
    XS xs = xs0;
    WS ws = ws0;
    xs.rows(m0, m0, mhi);
    ws.cols(n0);
    mainloop<kBN>(acc, smem, xs, ws, v_lo, min(v_hi, sh.kbase), tx, ty);
  }
  // the rank term, one pass per request in the tile (#12 has none)
  if constexpr (!std::is_same<BS, NoStage>::value) {
    if (v_hi > kpad) {
      PS ps = ps0;
      BS bs = bs0;
      bs.cols(n0);
      const int s_lo = max(v_lo, kpad) - kpad, s_hi = v_hi - kpad;
      for (int q = m0 / sh.s; q * sh.s < mhi; ++q) {
        ps.rows(m0, max(m0, q * sh.s), min(mhi, (q + 1) * sh.s));
        bs.adapter(sh.ids ? __ldg(sh.ids + q) : q);
        mainloop<kBN>(acc, smem, ps, bs, s_lo, s_hi, tx, ty);
      }
    }
  }

  float* dst = out + static_cast<size_t>(blockIdx.z) * sh.m * sh.n;
  const bool vec =
      sh.n % 4 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= sh.m) continue;
    float* o = dst + static_cast<size_t>(row) * sh.n;
#pragma unroll
    for (int g = 0; g < kNC; ++g) {
      const int col = n0 + g * 64 + tx * 4;
      const float* a = &acc[i][g * 4];
      if (vec && col < sh.n) {
        *reinterpret_cast<float4*>(o + col) =
            make_float4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < sh.n) o[col + c] = a[c];
      }
    }
  }
}

// out[i] = sum over z of part[z][i], z in order (deterministic).
template <bool kVec>
__global__ void fwd_sum_kernel(const float* __restrict__ part,
                               float* __restrict__ out, int total,
                               int splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (kVec) {
    if (idx >= total / 4) return;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int z = 0; z < splits; ++z) {
      const float4 v = reinterpret_cast<const float4*>(
          part + static_cast<size_t>(z) * total)[idx];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    reinterpret_cast<float4*>(out)[idx] = acc;
  } else {
    if (idx >= total) return;
    float acc = 0.f;
#pragma unroll 8
    for (int z = 0; z < splits; ++z)
      acc += part[static_cast<size_t>(z) * total + idx];
    out[idx] = acc;
  }
}

inline int fwd_sum(const float* part, float* out, int total, int splits,
                   cudaStream_t st) {
  if (total % 4 == 0)
    fwd_sum_kernel<true><<<(total / 4 + 255) / 256, 256, 0, st>>>(
        part, out, total, splits);
  else
    fwd_sum_kernel<false><<<(total + 255) / 256, 256, 0, st>>>(part, out,
                                                               total, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int kBN, class XS, class WS, class PS, class BS>
int fwd_pass(const XS& xs, const WS& ws, const PS& ps, const BS& bs,
             const FwdShape& sh, int splits, float* dst, cudaStream_t st) {
  constexpr size_t smem = Geo<kBN>::kSmem;
  // once per instantiation, at the first (eager) call: later calls may be
  // captured into a CUDA graph, where the attribute call does not belong
  static bool smem_set = false;
  if (smem > 48 * 1024 && !smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwd_kernel<kBN, XS, WS, PS, BS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid((sh.n + kBN - 1) / kBN, (sh.m + kFwdBM - 1) / kFwdBM,
                  splits);
  fwd_kernel<kBN, XS, WS, PS, BS><<<grid, kFwdThreads, smem, st>>>(
      xs, ws, ps, bs, sh, dst);
  return static_cast<int>(cudaGetLastError());
}

// The host's split plan (kernels/common.py fwd_plan): the pre-pass
// contracts k in ksplit_p chunks of kchunk_p, the main pass its range
// [0, roundup(k, kFwdBK) + r) in ksplit chunks of kchunk (whole slabs).
struct FwdPlan {
  int ksplit_p, kchunk_p, ksplit, kchunk;
};

// The vector paths' conditions on the shapes and the operands x, A, B, p
// (16-byte aligned: cp.async and float4 loads); the W loader adds its own.
inline bool fwd_vec(int k, int n, int r, const void* x, const void* a,
                    const void* b, const float* p) {
  return k % 4 == 0 && n % 4 == 0 && r % 4 == 0 && is_aligned(x, 16) &&
         is_aligned(a, 16) && is_aligned(b, 16) && is_aligned(p, 16);
}

// p = x A_row^T (pre-pass; a_stride = r * k between adapters), then
// out = x W + gamma p B_row^T (b_stride = n * r), over the W stager w
// (ColsDense, ColsInt8 or ColsInt4 with kVec matching).  scratch holds the
// larger pass's partials (ksplit_p * m * r or ksplit * m * n floats) when
// it splits.
template <typename T, typename WS>
int fwd_rank_fused(const T* x, const WS& w, const T* a, const T* b,
                   size_t a_stride, size_t b_stride, const int* ids, int s,
                   float gamma, float* p, float* scratch, float* out, int m,
                   int k, int n, int r, const FwdPlan& plan,
                   cudaStream_t st) {
  constexpr bool kVec = WS::kVec;
  using Pre = ColsT<kFwdPreBN, T, kVec>;
  using Rank = ColsT<kFwdMainBN, T, kVec>;
  int err = fwd_pass<kFwdPreBN>(
      NoStage{}, NoStage{}, Rows<T, kVec>{x, k},
      Pre{a, k, r, a_stride, 1.f}, FwdShape{m, r, 0, k, plan.kchunk_p, s, ids},
      plan.ksplit_p, plan.ksplit_p > 1 ? scratch : p, st);
  if (err != 0) return err;
  if (plan.ksplit_p > 1) {
    err = fwd_sum(scratch, p, m * r, plan.ksplit_p, st);
    if (err != 0) return err;
  }
  err = fwd_pass<kFwdMainBN>(
      Rows<T, kVec>{x, k}, w, Rows<float, kVec>{p, r},
      Rank{b, r, n, b_stride, gamma},
      FwdShape{m, n, k, r, plan.kchunk, s, ids}, plan.ksplit,
      plan.ksplit > 1 ? scratch : out, st);
  if (err != 0 || plan.ksplit == 1) return err;
  return fwd_sum(scratch, out, m * n, plan.ksplit, st);
}

// out (m, nout) = x (m, kc) times the right stager w, with no rank term:
// #11's y = x dequant(W) over ColsInt8 / ColsInt4 (kc = k, nout = n), and
// #12's dx = g dequant(W)^T over RowsInt8 / RowsInt4 (kc = W's n, nout =
// its k).  The contraction runs in ksplit chunks of kchunk (whole slabs);
// when it splits, the chunks' partials (scratch, ksplit * m * nout floats)
// are added in a fixed order.
template <typename T, typename WS>
int fwd_base_only(const T* x, const WS& w, float* scratch, float* out, int m,
                  int kc, int nout, int ksplit, int kchunk, cudaStream_t st) {
  const int err = fwd_pass<kFwdMainBN>(
      Rows<T, WS::kVec>{x, kc}, w, NoStage{}, NoStage{},
      FwdShape{m, nout, kc, 0, kchunk, m, nullptr}, ksplit,
      ksplit > 1 ? scratch : out, st);
  if (err != 0 || ksplit == 1) return err;
  return fwd_sum(scratch, out, m * nout, ksplit, st);
}

// #6 and #10: q = g B (pre-pass), then dx = g W^T + gamma q A, with g
// (m, n), W (dense, or packed and dequantized) read by row through w
// (ColsT, RowsInt8 / RowsInt4, kVec matching), A (r, k) and B (n, r):
// #12's main pass with #5's rank tail, the operands' roles swapped.  The
// pre-pass is an (m, r) output contracting n, with B row-major as the
// right operand; the main pass contracts its range [0,
// roundup(n, kFwdBK) + r): n against W's rows, then r of q rows against
// gamma A.  q is written (the residual #7 reuses); scratch holds the larger
// pass's partials (ksplit_p * m * r or ksplit * m * k floats) when it
// splits (kernels/common.py dx_plan).
template <typename T, typename WS>
int dx_rank_fused(const T* g, const WS& w, const T* a, const T* b,
                  float gamma, float* q, float* scratch, float* dx, int m,
                  int k, int n, int r, const FwdPlan& plan, cudaStream_t st) {
  constexpr bool kVec = WS::kVec;
  int err = fwd_pass<kFwdPreBN>(
      NoStage{}, NoStage{}, Rows<T, kVec>{g, n},
      ColsDense<kFwdPreBN, T, kVec>{b, r, r},
      FwdShape{m, r, 0, n, plan.kchunk_p, m, nullptr}, plan.ksplit_p,
      plan.ksplit_p > 1 ? scratch : q, st);
  if (err != 0) return err;
  if (plan.ksplit_p > 1) {
    err = fwd_sum(scratch, q, m * r, plan.ksplit_p, st);
    if (err != 0) return err;
  }
  err = fwd_pass<kFwdMainBN>(
      Rows<T, kVec>{g, n}, w, Rows<float, kVec>{q, r},
      ColsDense<kFwdMainBN, T, kVec, true>{a, k, k, gamma},
      FwdShape{m, k, n, r, plan.kchunk, m, nullptr}, plan.ksplit,
      plan.ksplit > 1 ? scratch : dx, st);
  if (err != 0 || plan.ksplit == 1) return err;
  return fwd_sum(scratch, dx, m * k, plan.ksplit, st);
}

// f(W stager) for a dense W (k, n) of T, on the vector path when vec.
template <typename T, typename F>
int with_dense_cols(const T* w, int n, bool vec, F&& f) {
  if (vec && is_aligned(w, 16))
    return f(ColsDense<kFwdMainBN, T, true>{w, n, n});
  return f(ColsDense<kFwdMainBN, T, false>{w, n, n});
}

// f(W stager) for a dense W (k, n) of T read by row (ColsT: the right
// operand of dx = g W^T), on the vector path when vec (n % 4 == 0, checked
// by the caller) and W is 16-byte aligned.
template <typename T, typename F>
int with_dense_rows(const T* w, int n, int k, bool vec, F&& f) {
  if (vec && is_aligned(w, 16))
    return f(ColsT<kFwdMainBN, T, true>{w, n, k, 0, 1.f, w});
  return f(ColsT<kFwdMainBN, T, false>{w, n, k, 0, 1.f, w});
}

// f(W stager) for a packed W (loaders.cuh's layout), or
// cudaErrorInvalidValue for bits other than 8 and 4.  The vector path
// also needs 4-byte aligned data, 16-byte aligned scales and (int4) groups
// of whole slabs.
template <bool kVec, typename F>
int with_packed_cols_v(const void* wd, const float* ws, int n, int bits,
                       int group, int bf16w, F&& f) {
  if (bits == 8) {
    const int8_t* d = static_cast<const int8_t*>(wd);
    return bf16w ? f(ColsInt8<kFwdMainBN, true, kVec>{{d, ws, n}})
                 : f(ColsInt8<kFwdMainBN, false, kVec>{{d, ws, n}});
  }
  if (bits == 4) {
    const uint8_t* d = static_cast<const uint8_t*>(wd);
    const int shift = log2_group(group);
    return bf16w ? f(ColsInt4<kFwdMainBN, true, kVec>{{d, ws, n, shift}})
                 : f(ColsInt4<kFwdMainBN, false, kVec>{{d, ws, n, shift}});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename F>
int with_packed_cols(const void* wd, const float* ws, int n, int bits,
                     int group, int bf16w, bool vec, F&& f) {
  if (vec && is_aligned(wd, 4) && is_aligned(ws, 16) &&
      (bits != 4 || group % kFwdBK == 0))
    return with_packed_cols_v<true>(wd, ws, n, bits, group, bf16w, f);
  return with_packed_cols_v<false>(wd, ws, n, bits, group, bf16w, f);
}

// f(W stager) for a packed W (k, n) read by row (RowsInt8 / RowsInt4: the
// right operand of dx = g dequant(W)^T), or cudaErrorInvalidValue for bits
// other than 8 and 4.  The vector path also needs n % 4 == 0 (checked by
// the caller with g's alignment), 4-byte aligned data and 16-byte aligned
// scales; it has no condition on the int4 group (the contraction runs along
// n, and every group holds both rows of a byte).
template <bool kVec, typename F>
int with_packed_rows_v(const void* wd, const float* ws, int n, int k,
                       int bits, int group, int bf16w, F&& f) {
  if (bits == 8) {
    const int8_t* d = static_cast<const int8_t*>(wd);
    return bf16w ? f(RowsInt8<kFwdMainBN, true, kVec>{{d, ws, n}, k})
                 : f(RowsInt8<kFwdMainBN, false, kVec>{{d, ws, n}, k});
  }
  if (bits == 4) {
    const uint8_t* d = static_cast<const uint8_t*>(wd);
    const int shift = log2_group(group);
    return bf16w
               ? f(RowsInt4<kFwdMainBN, true, kVec>{{d, ws, n, shift}, k})
               : f(RowsInt4<kFwdMainBN, false, kVec>{{d, ws, n, shift}, k});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename F>
int with_packed_rows(const void* wd, const float* ws, int n, int k, int bits,
                     int group, int bf16w, bool vec, F&& f) {
  if (vec && is_aligned(wd, 4) && is_aligned(ws, 16))
    return with_packed_rows_v<true>(wd, ws, n, k, bits, group, bf16w, f);
  return with_packed_rows_v<false>(wd, ws, n, k, bits, group, bf16w, f);
}

}  // namespace
}  // namespace repro_kernels
