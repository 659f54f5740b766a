// The decode GEMV of qgemv.cu: y = x W for a few rows of x, W packed int8
// / int4 (loaders.cuh's layout) or dense fp32 / bf16, and optionally the
// BGMV rank term.  One body serves three kernels:
//   #11's decode form  (_qmm_kernel, src/repro/kernels/lora_matmul.py:514,
//                       m <= 8 rows, packed W; qgemv_partial),
//   #4 bgmv_gemv_quant (_bgmv_gemv_kernel_q, src/repro/kernels/bgmv.py:251,
//                       packed W; bgmv_gemv_body),
//   #1 bgmv_gemv       (_bgmv_gemv_kernel, bgmv.py:114, dense W;
//                       bgmv_gemv_body).
// The TPU kernels read a (tm, tk) x block and a (tk, tn) W block per grid
// step and (#1, #4) carry p = x A^T in VMEM across the n sweep.  On an H100
// a decode call is bound by the bytes of W (int4 w_up of gemma-2b: 2048 x
// 16384 / 2 = 16.8 MB, 5.0 us at 3.35 TB/s; fp32 q 16.8 MB too), with 1 to
// 16 flops per byte.  The split-k GEMV this replaced (gemv.cuh, since
// deleted) ran at 3-21x that bound: a lane owned one column, so each warp
// load was 32 elements, an int4 byte was loaded once per nibble row, every
// element reloaded its scale and its x values from global memory, and #1 /
// #4 took a third launch for p.  Here:
//   - a warp copies 256 contiguous bytes of a W row in 16-byte pieces
//     (8-byte ones where only that is aligned, single bytes where rows are
//     not), and each lane computes the columns of 8 of those bytes: 8 of a
//     packed row (int8, or int4's byte row holding two rows of k), 4 of
//     bf16, 2 of fp32.  The stages are sized in bytes, not columns, so the
//     rings stay 32 KB a block for every format: a dense format covers
//     fewer columns a block (64 fp32, 128 bf16, against 256 packed) and the
//     plan gives it more column blocks.  By Little's law 3.35 TB/s x ~1 us
//     over 132 SMs wants about 25 KB in flight an SM; a block keeps 3 of
//     its 4 stages (24 KB) in flight, and the plans put 1-2 blocks (#11)
//     or 2-4 (#1, #4) on each SM, of the 3-6 that fit (ptxas: 40-48
//     registers at 4 rows of x over a dense W, 64-75 over a packed one, no
//     spill);
//   - each warp streams its rows through its own ring in shared memory (4
//     stages of 4 rows, cp.async), so 12 rows' loads are in flight while it
//     computes the current 4, and the first ones while the block stages x;
//   - packed rows decode word-wide, without I2F (loaders.cuh s8_float /
//     s4_float), each element dequantize's fp32 product float(q) * scale,
//     rounded to bf16 for a base packed from bf16 weights, and a lane loads
//     its columns' scales once per block (int8) or per group of rows
//     (int4); a bf16 element is the top half of its fp32;
//   - the block stages its k-chunk of x as fp32 in shared memory (x[t][b],
//     one broadcast load of all rows per W row), each thread's loads issued
//     before its stores;
//   - the block's 8 warps split the chunk's rows and add their sums in
//     shared memory in warp order; k splits over grid y by a host plan
//     (kernels/common.py qgemv_split, gemv_plan: shapes and SM count only),
//     rows of x go in groups of up to 8 over grid z (W read once a group);
//   - the rank term (BankRank): each (chunk, row group) gets rank blocks
//     beside its column blocks (grid x past them), 32 pairs (b, j) each,
//     which stage the same x and form p_q[b, j] = sum over the chunk of
//     x[b, k] A[id_b, j, k], a warp taking 4 pairs at once, while the
//     column blocks stream W; a second kernel adds the chunks' partials of
//     y and of p in chunk order and then p B[id_b]^T: two launches a call,
//     no atomics, so a run repeats bit for bit.  The second kernel is
//     launched as a programmatic dependent of the GEMV (its blocks start,
//     and load B, while the GEMV runs, then wait for it).  #11 (NoRank)
//     sums its partials with fwd_tile.cuh's fixed-order pass, and skips it
//     when k is one chunk.
// The rows of x are a template parameter (1, 2, 4 or 8; rows past m are
// zeros that no output reads), so m = 4 does 4 FMAs per element, not 8.
// Over a packed W what limits it is instructions, not bytes: at 4 rows of
// x an element costs about 7.5 (byte permute, exact subtraction, scale
// product, 4 FMAs, a share of the word's masks), and int4 w_up at m = 4
// spends 18 us in this kernel against the 5.0 us byte time (PERF.md).  A
// dense row costs 1.25 instructions a byte and stays bound by its bytes.
#pragma once

#include <cuda_runtime.h>

namespace repro_kernels {

constexpr int kQgWarps = 8;        // warps per block: they split its k-chunk
constexpr int kQgMaxRows = 8;      // rows of x a block takes
constexpr int kQgSlab = 16;        // a chunk of k is whole slabs of rows
constexpr int kQgMaxChunk = 1024;  // rows of k a block stages (x in smem)

// #11's decode form: out = x (m, k) times dequant(W) (logical (k, n)), as
// ksplit partials (ksplit, m, n) over chunks of kchunk rows of k, or y
// itself when ksplit is 1.  x fp32, or bf16 when x_bf16; wd, ws, bits,
// group and bf16w as quant_matmul_launch takes them.  Returns
// cudaErrorInvalidValue for m outside [1, kQgMaxRows], a kchunk that is not
// whole slabs up to kQgMaxChunk, a plan that does not cover k, or bits
// other than 8 and 4.
int qgemv_partial(const void* x, bool x_bf16, const void* wd, const float* ws,
                  float* out, int m, int k, int n, int ksplit, int kchunk,
                  int bits, int group, int bf16w, cudaStream_t st);

// #1 and #4: out[i] = x[i] W + (x[i] A[id_i]^T) B[id_i]^T for m >= 1 rows
// of x (k), id_i = ids[i] (ids == nullptr: i), A (K, r, k) and B (K, n, r)
// of x's type (fp32, or bf16 when x_bf16).  W: packed as for qgemv_partial
// when bits is 8 or 4; dense (k, n) of x's type when bits is 0 (ws, group
// and bf16w unused).  p: an fp32 scratch (ksplit, m, r), partial one of
// (ksplit, m, n); out (m, n) fp32.  Two launches: the GEMV with the rank
// partials, then the fixed-order pass.  Returns cudaErrorInvalidValue for
// m, r < 1, r > kQgMaxRank, a plan as qgemv_partial refuses, or other bits.
constexpr int kQgMaxRank = 8192;  // p[b, :] of a row in the pass's smem
int bgmv_gemv_body(const void* x, bool x_bf16, const void* wd,
                   const float* ws, const void* a, const void* b,
                   const int* ids, float* p, float* partial, float* out,
                   int m, int k, int n, int r, int ksplit, int kchunk,
                   int bits, int group, int bf16w, cudaStream_t st);

}  // namespace repro_kernels
