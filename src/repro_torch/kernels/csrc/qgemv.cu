// The packed GEMV of #11's decode form (qgemv.cuh says what it replaces,
// what bounds it and what the design does about it).  Its own translation
// unit, so that its 48 instantiations (rows of x 1 / 2 / 4 / 8, three load
// widths, int8 / int4, bf16 rounding or not) build in parallel with
// lora_matmul.cu, which calls qgemv_partial.
#include "qgemv.cuh"

#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

#include "loaders.cuh"

namespace repro_kernels {
namespace {

// Each warp streams its rows through its own ring of shared memory:
// kQgStages stages of kQgRows packed rows, filled by cp.async, so the next
// stages' loads fly while the warp decodes the current one, and the first
// ones while the block stages x.  A warp covers kQgWarpCols columns, a lane
// kQgLaneCols of them; the copies are as wide as the rows' alignment allows
// (kLoad 16 or 8 bytes, each lane copying its share of the stage's rows),
// or single bytes (kLoad 1: odd n) that each lane loads for its own columns.
constexpr int kQgRows = 4;          // packed rows a stage holds
constexpr int kQgStages = 4;        // stages a warp has in flight
constexpr int kQgLaneCols = 8;      // columns (bytes of a packed row) a lane
constexpr int kQgWarpCols = 32 * kQgLaneCols;
constexpr int kQgStageBytes = kQgRows * kQgWarpCols;
constexpr int kQgRingBytes = kQgWarps * kQgStages * kQgStageBytes;

// Copy bytes [c0, c0 + kQgWarpCols) of packed rows [row0, row0 + kQgRows)
// (none at or past rb) into one stage of the warp's ring (row u at stage +
// u kQgWarpCols): kLoad-byte pieces spread over the lanes, or (kLoad 1)
// this lane's kQgLaneCols bytes of each row, zero past n.
template <int kLoad>
__device__ __forceinline__ void fetch_stage(uint8_t* stage,
                                            const uint8_t* wd, int row0,
                                            int rb, int c0, int n,
                                            int lane) {
  if constexpr (kLoad == 1) {
    const int col = c0 + lane * kQgLaneCols;
#pragma unroll
    for (int u = 0; u < kQgRows; ++u) {
      if (row0 + u >= rb) break;
      const uint8_t* src = wd + static_cast<size_t>(row0 + u) * n;
      unsigned w[2] = {0u, 0u};
#pragma unroll
      for (int c = 0; c < kQgLaneCols; ++c)
        if (col + c < n)
          w[c / 4] |= static_cast<unsigned>(__ldg(src + col + c))
                      << (8 * (c % 4));
      *reinterpret_cast<uint2*>(stage + u * kQgWarpCols +
                                lane * kQgLaneCols) = make_uint2(w[0], w[1]);
    }
  } else {
    constexpr int kPerRow = kQgWarpCols / kLoad;  // pieces of a row
#pragma unroll
    for (int i = 0; i < kQgRows * kPerRow / 32; ++i) {
      const int piece = lane + 32 * i;
      const int u = piece / kPerRow, off = (piece % kPerRow) * kLoad;
      // n is a multiple of kLoad: a piece lies in the row or past n
      if (row0 + u < rb && c0 + off < n)
        cp_async<kLoad>(stage + u * kQgWarpCols + off,
                        wd + static_cast<size_t>(row0 + u) * n + c0 + off);
    }
  }
}

// The 2 words of one row (in a stage) that hold this lane's columns.
__device__ __forceinline__ void read_words(const uint8_t* row, int lane,
                                           unsigned (&w)[2]) {
  const uint2 u = *reinterpret_cast<const uint2*>(row + lane * kQgLaneCols);
  w[0] = u.x;
  w[1] = u.y;
}

// The scales of columns [col, col + kQgLaneCols) of one scale row, zero
// past n (vector loads where n is a multiple of 8 and the scales aligned).
template <bool kVecScales>
__device__ __forceinline__ void load_scales(const float* s, int col, int n,
                                            float (&sc)[kQgLaneCols]) {
  if constexpr (!kVecScales) {
#pragma unroll
    for (int c = 0; c < kQgLaneCols; ++c)
      sc[c] = col + c < n ? __ldg(s + col + c) : 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < kQgLaneCols / 4; ++i) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(s + col) + i);
      sc[4 * i] = f.x;
      sc[4 * i + 1] = f.y;
      sc[4 * i + 2] = f.z;
      sc[4 * i + 3] = f.w;
    }
  }
}

// v[b] = xs[b] for the kMB rows of x at one k row (one broadcast load)
template <int kMB>
__device__ __forceinline__ void load_x(const float* xs, float (&v)[kMB]) {
  if constexpr (kMB % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kMB / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(xs)[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else if constexpr (kMB == 2) {
    const float2 f = *reinterpret_cast<const float2*>(xs);
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = xs[0];
  }
}

// acc[b][c] += x(b, row) W(row, col + c) over one packed row's words: int8
// one row (x0), int4 the two rows of its byte row (x0 the even, x1 the odd)
template <int kMB, int kV, int kBits, bool kBf16>
__device__ __forceinline__ void fma_row(float (&acc)[kMB][kV],
                                        const unsigned (&w)[kV / 4],
                                        const float (&sc)[kV],
                                        const float (&x0)[kMB],
                                        const float (&x1)[kMB]) {
#pragma unroll
  for (int i = 0; i < kV / 4; ++i) {
    if constexpr (kBits == 8) {
      const unsigned xw = w[i] ^ 0x80808080u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = dequant<kBf16>(s8_float(xw, c), sc[4 * i + c]);
#pragma unroll
        for (int b = 0; b < kMB; ++b)
          acc[b][4 * i + c] = fmaf(x0[b], e, acc[b][4 * i + c]);
      }
    } else {
      const unsigned xw = w[i] ^ 0x88888888u;
      const unsigned lo = xw & 0x0F0F0F0Fu, hi = (xw >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e0 = dequant<kBf16>(s4_float(lo, c), sc[4 * i + c]);
        const float e1 = dequant<kBf16>(s4_float(hi, c), sc[4 * i + c]);
#pragma unroll
        for (int b = 0; b < kMB; ++b) {
          acc[b][4 * i + c] = fmaf(x0[b], e0, acc[b][4 * i + c]);
          acc[b][4 * i + c] = fmaf(x1[b], e1, acc[b][4 * i + c]);
        }
      }
    }
  }
}

// Block (blockIdx.x, blockIdx.y): columns [blockIdx.x kQgWarpCols, +
// kQgWarpCols), rows [k0, k1) of k with k0 = blockIdx.y kchunk, into
// out[blockIdx.y][b][j].  Warp w walks its share of the chunk's packed rows,
// contiguous, through its ring; lane l computes columns [l kQgLaneCols, +
// kQgLaneCols) of the block's.  Dynamic shared memory: the rings, then x's
// chunk.
template <int kMB, int kLoad, int kBits, bool kBf16>
__global__ void __launch_bounds__(kQgWarps * 32)
qgemv_kernel(const void* __restrict__ x, int x_bf16,
             const uint8_t* __restrict__ wd, const float* __restrict__ ws,
             float* __restrict__ out, int m, int k, int n, int kchunk,
             int group_shift) {
  constexpr int kV = kQgLaneCols;
  constexpr int kP = kBits == 4 ? 2 : 1;  // rows of k per packed row
  extern __shared__ float4 qg_smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(qg_smem4);
  float* xs = reinterpret_cast<float*>(ring + kQgRingBytes);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kQgWarpCols, col = c0 + lane * kV;
  const int k0 = blockIdx.y * kchunk, k1 = min(k, k0 + kchunk);
  // this warp's packed rows [ra, rb) of the chunk's [k0 / kP, ceil(k1 / kP))
  const int r0 = k0 / kP, r1 = (k1 + kP - 1) / kP;
  const int per = (r1 - r0 + kQgWarps - 1) / kQgWarps;
  const int ra = min(r1, r0 + warp * per), rb = min(r1, ra + per);
  const int nsteps = (rb - ra + kQgRows - 1) / kQgRows;
  uint8_t* wring = ring + warp * kQgStages * kQgStageBytes;

  // the first stages' loads and the first scale row, in flight while the
  // block stages x
#pragma unroll
  for (int st = 0; st < kQgStages - 1; ++st) {
    if (st < nsteps)
      fetch_stage<kLoad>(wring + st * kQgStageBytes, wd, ra + st * kQgRows,
                         rb, c0, n, lane);
    cp_async_commit();
  }
  float sc[kV];
  int grp = (kP * ra) >> group_shift;  // the scale row sc holds (int4)
  if (col < n && ra < rb)
    load_scales<kLoad != 1>(
        ws + static_cast<size_t>(kBits == 4 ? grp : 0) * n, col, n, sc);

  // xs[t kMB + b] = x[b, k0 + t] as fp32, zero past k1 and past m: all of
  // a thread's loads (at most kMB x 4) issued before its first store
  constexpr int kT = kQgMaxChunk / (kQgWarps * 32);
  float xv[kMB][kT];
#pragma unroll
  for (int b = 0; b < kMB; ++b)
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int t = threadIdx.x + j * kQgWarps * 32;
      xv[b][j] = 0.f;
      if (b < m && k0 + t < k1) {
        const size_t at = static_cast<size_t>(b) * k + k0 + t;
        xv[b][j] = x_bf16 ? __bfloat162float(
                                static_cast<const __nv_bfloat16*>(x)[at])
                          : static_cast<const float*>(x)[at];
      }
    }
#pragma unroll
  for (int b = 0; b < kMB; ++b)
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int t = threadIdx.x + j * kQgWarps * 32;
      if (t < kchunk) xs[t * kMB + b] = xv[b][j];
    }
  __syncthreads();

  float acc[kMB][kV];
#pragma unroll
  for (int b = 0; b < kMB; ++b)
#pragma unroll
    for (int c = 0; c < kV; ++c) acc[b][c] = 0.f;
  for (int it = 0; it < nsteps; ++it) {
    // the warp's copies of step it are done, and every lane is done with
    // step it - 1, whose stage the copies of step it + 3 refill
    cp_async_wait<kQgStages - 2>();
    __syncwarp();
    const int nx = it + kQgStages - 1;
    if (nx < nsteps)
      fetch_stage<kLoad>(wring + (nx % kQgStages) * kQgStageBytes, wd,
                         ra + nx * kQgRows, rb, c0, n, lane);
    cp_async_commit();
    if (col >= n) continue;
    const uint8_t* cur = wring + (it % kQgStages) * kQgStageBytes;
#pragma unroll
    for (int u = 0; u < kQgRows; ++u) {
      const int row = ra + it * kQgRows + u;
      if (row >= rb) break;
      if constexpr (kBits == 4) {
        const int g = (kP * row) >> group_shift;
        if (g != grp) {  // the warp's rows entered the next scale group
          grp = g;
          load_scales<kLoad != 1>(ws + static_cast<size_t>(g) * n, col, n,
                                  sc);
        }
      }
      unsigned w[2];
      read_words(cur + u * kQgWarpCols, lane, w);
      const float* xr = xs + (kP * row - k0) * kMB;
      float x0[kMB], x1[kMB];
      load_x<kMB>(xr, x0);
      if constexpr (kBits == 4) load_x<kMB>(xr + kMB, x1);
      fma_row<kMB, kV, kBits, kBf16>(acc, w, sc, x0, kBits == 4 ? x1 : x0);
    }
  }
  cp_async_wait<0>();

  // the warps' sums, added in warp order through shared memory (the rings),
  // up to 4 rows of x at a time
  constexpr int kRedRows = kMB < 4 ? kMB : 4;
  __syncthreads();  // every warp is done with its ring
  float* red = reinterpret_cast<float*>(ring);  // [row][warp][kQgWarpCols]
  static_assert(kRedRows * kQgWarps * kQgWarpCols * sizeof(float) <=
                    kQgRingBytes,
                "the reduction fits in the rings");
#pragma unroll
  for (int b0 = 0; b0 < kMB; b0 += kRedRows) {
    if (b0 >= m) break;
#pragma unroll
    for (int r = 0; r < kRedRows; ++r)
#pragma unroll
      for (int i = 0; i < kV / 4; ++i)
        *reinterpret_cast<float4*>(
            red + (r * kQgWarps + warp) * kQgWarpCols + lane * kV + 4 * i) =
            make_float4(acc[b0 + r][4 * i], acc[b0 + r][4 * i + 1],
                        acc[b0 + r][4 * i + 2], acc[b0 + r][4 * i + 3]);
    __syncthreads();
    for (int e = threadIdx.x; e < kRedRows * kQgWarpCols;
         e += kQgWarps * 32) {
      const int r = e / kQgWarpCols, c = e % kQgWarpCols, j = c0 + c;
      if (b0 + r < m && j < n) {
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < kQgWarps; ++q)
          sum += red[(r * kQgWarps + q) * kQgWarpCols + c];
        out[(static_cast<size_t>(blockIdx.y) * m + b0 + r) * n + j] = sum;
      }
    }
    __syncthreads();
  }
}

template <int kMB, int kLoad, int kBits, bool kBf16>
int launch(const void* x, bool x_bf16, const void* wd, const float* ws,
           float* out, int m, int k, int n, int ksplit, int kchunk,
           int group_shift, cudaStream_t st) {
  constexpr size_t kMaxSmem = kQgRingBytes + sizeof(float) * kQgMaxChunk * kMB;
  // once per instantiation, at the first (eager) call: later calls may be
  // captured into a CUDA graph, where the attribute call does not belong
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        qgemv_kernel<kMB, kLoad, kBits, kBf16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const size_t smem = kQgRingBytes + sizeof(float) * kchunk * kMB;
  const dim3 grid((n + kQgWarpCols - 1) / kQgWarpCols, ksplit);
  qgemv_kernel<kMB, kLoad, kBits, kBf16><<<grid, kQgWarps * 32, smem, st>>>(
      x, x_bf16 ? 1 : 0, static_cast<const uint8_t*>(wd), ws, out, m, k, n,
      kchunk, group_shift);
  return static_cast<int>(cudaGetLastError());
}

template <int kMB, int kLoad>
int by_packing(const void* x, bool x_bf16, const void* wd, const float* ws,
               float* out, int m, int k, int n, int ksplit, int kchunk,
               int bits, int group, int bf16w, cudaStream_t st) {
  if (bits == 8)
    return bf16w ? launch<kMB, kLoad, 8, true>(x, x_bf16, wd, ws, out, m, k,
                                               n, ksplit, kchunk, 0, st)
                 : launch<kMB, kLoad, 8, false>(x, x_bf16, wd, ws, out, m, k,
                                                n, ksplit, kchunk, 0, st);
  const int shift = log2_group(group);
  return bf16w ? launch<kMB, kLoad, 4, true>(x, x_bf16, wd, ws, out, m, k, n,
                                             ksplit, kchunk, shift, st)
               : launch<kMB, kLoad, 4, false>(x, x_bf16, wd, ws, out, m, k, n,
                                              ksplit, kchunk, shift, st);
}

// 16-byte loads where W's rows and the scales allow them, else 8, else
// single bytes (odd n)
template <int kMB>
int by_load(const void* x, bool x_bf16, const void* wd, const float* ws,
            float* out, int m, int k, int n, int ksplit, int kchunk, int bits,
            int group, int bf16w, cudaStream_t st) {
  if (n % 16 == 0 && is_aligned(wd, 16) && is_aligned(ws, 16))
    return by_packing<kMB, 16>(x, x_bf16, wd, ws, out, m, k, n, ksplit,
                               kchunk, bits, group, bf16w, st);
  if (n % 8 == 0 && is_aligned(wd, 8) && is_aligned(ws, 16))
    return by_packing<kMB, 8>(x, x_bf16, wd, ws, out, m, k, n, ksplit,
                              kchunk, bits, group, bf16w, st);
  return by_packing<kMB, 1>(x, x_bf16, wd, ws, out, m, k, n, ksplit, kchunk,
                            bits, group, bf16w, st);
}

}  // namespace

int qgemv_partial(const void* x, bool x_bf16, const void* wd, const float* ws,
                  float* out, int m, int k, int n, int ksplit, int kchunk,
                  int bits, int group, int bf16w, cudaStream_t st) {
  if (m < 1 || m > kQgMaxRows || kchunk <= 0 || kchunk % kQgSlab != 0 ||
      kchunk > kQgMaxChunk || ksplit < 1 ||
      static_cast<long long>(ksplit) * kchunk < k ||
      static_cast<long long>(ksplit - 1) * kchunk >= k ||
      (bits != 8 && bits != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 1)
    return by_load<1>(x, x_bf16, wd, ws, out, m, k, n, ksplit, kchunk, bits,
                      group, bf16w, st);
  if (m == 2)
    return by_load<2>(x, x_bf16, wd, ws, out, m, k, n, ksplit, kchunk, bits,
                      group, bf16w, st);
  if (m <= 4)
    return by_load<4>(x, x_bf16, wd, ws, out, m, k, n, ksplit, kchunk, bits,
                      group, bf16w, st);
  return by_load<8>(x, x_bf16, wd, ws, out, m, k, n, ksplit, kchunk, bits,
                    group, bf16w, st);
}

}  // namespace repro_kernels
