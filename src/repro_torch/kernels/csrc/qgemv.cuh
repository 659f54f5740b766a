// #11's decode form, y = x dequant(W) for m <= 8 rows of x over a packed
// int8 / int4 W (loaders.cuh's layout): the packed GEMV of qgemv.cu.
//
// Replaces _qmm_kernel (src/repro/kernels/lora_matmul.py:514, via _qmm_call
// :525) at decode shapes, where the TPU kernel reads a (tm, tk) x block and
// a (tk, tn) packed block per grid step.  On an H100 the call is bound by
// the packed bytes of W (int4 w_up of gemma-2b: 2048 x 16384 / 2 = 16.8 MB,
// 5.0 us at 3.35 TB/s; int8 twice that), with 2 to 16 flops per byte.  The
// split-k GEMV it replaces (gemv.cuh, shared with #1 / #4) ran at 21x that
// bound: a lane owned one column, so each warp load was 32 bytes, an int4
// byte was loaded once per nibble row, and every element reloaded its scale
// and its x values from global memory; the time went to load latency.
// Here:
//   - a warp copies 256 contiguous bytes of a row (one row of int8, or the
//     byte row holding two rows of int4) in 16-byte pieces, 8-byte ones
//     where only that is aligned, single bytes where rows are not (odd n),
//     and each lane computes 8 of those columns (8 x the rows of x
//     accumulators: 69-73 registers at 4 rows, so 3 blocks fit an SM);
//   - each warp streams its rows through its own ring in shared memory (4
//     stages of 4 rows, cp.async), so 12 rows' loads are in flight while it
//     decodes the current 4, and the first ones while the block stages x:
//     the loads no longer wait in line behind the arithmetic;
//   - decode is word-wide, without I2F (loaders.cuh s8_float / s4_float),
//     and each element is still dequantize's fp32 product float(q) * scale,
//     rounded to bf16 for a base packed from bf16 weights, so kernel and
//     plain version differ only in the order of their sums;
//   - a lane loads its columns' scales once per block (int8) or once per
//     group of rows (int4: a warp walks a contiguous range of rows, so a
//     group's scale row is loaded where the range enters it);
//   - the block stages its k-chunk of the m rows of x in shared memory as
//     fp32 (x[t][b], one broadcast load of all rows per W row), each
//     thread's loads issued before its stores;
//   - the block's 8 warps split the chunk's rows and add their sums in
//     shared memory in a fixed order; k splits over grid y by a host plan
//     (kernels/common.py qgemv_split, from the shapes and the SM count), the
//     ksplit partials summed by fwd_tile.cuh's fixed-order pass.  No
//     atomics: a run repeats bit for bit.
// The rows of x are a template parameter (1, 2, 4 or 8; rows past m are
// zeros that no output reads), so m = 4 does 4 FMAs per element, not 8.
// What limits it now is instructions, not bytes: at 4 rows of x an element
// costs about 7.5 (byte permute, exact subtraction, scale product, 4 FMAs,
// a share of the word's masks), and the packed GEMV of int4 w_up at m = 4
// spends 18 us in this kernel against the 5.0 us byte time (PERF.md).
#pragma once

#include <cuda_runtime.h>

namespace repro_kernels {

constexpr int kQgWarps = 8;        // warps per block: they split its k-chunk
constexpr int kQgMaxRows = 8;      // rows of x per call
constexpr int kQgSlab = 16;        // a chunk of k is whole slabs of rows
constexpr int kQgMaxChunk = 1024;  // rows of k a block stages (x in smem)

// out = x (m, k) times dequant(W) (logical (k, n)), as ksplit partials
// (ksplit, m, n) over chunks of kchunk rows of k, or y itself when ksplit
// is 1.  x fp32, or bf16 when x_bf16; wd, ws, bits, group and bf16w as
// quant_matmul_launch takes them.  Returns cudaErrorInvalidValue for m
// outside [1, kQgMaxRows], a kchunk that is not whole slabs up to
// kQgMaxChunk, a plan that does not cover k, or bits other than 8 and 4.
int qgemv_partial(const void* x, bool x_bf16, const void* wd, const float* ws,
                  float* out, int m, int k, int n, int ksplit, int kchunk,
                  int bits, int group, int bf16w, cudaStream_t st);

}  // namespace repro_kernels
