// The decode GEMV body of #1, #4 and #11's decode form, and #1 / #4's
// fixed-order pass (qgemv.cuh says what they replace, what bounds them and
// what the design does about it).  Its own translation unit, so that its
// 120 instantiations (rows of x 1 / 2 / 4 / 8, three load widths; #11 over
// int8 / int4 with bf16 rounding or not; #4 the same with the rank term; #1
// over fp32 / bf16) build in parallel with the files that call it.
#include "qgemv.cuh"

#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

#include "loaders.cuh"

namespace repro_kernels {
namespace {

// Each warp streams its rows through its own ring of shared memory:
// kQgStages stages of kQgRows W rows, filled by cp.async, so the next
// stages' loads fly while the warp computes on the current one, and the
// first ones while the block stages x.  A warp covers kQgWarpBytes bytes of
// a row, a lane kQgLaneBytes of them; the copies are as wide as the rows'
// alignment allows (kLoad 16 or 8 bytes, each lane copying its share of the
// stage's rows), or single bytes (kLoad 1: rows of an odd byte length) that
// each lane loads for its own columns.
constexpr int kQgRows = 4;          // W rows a stage holds
constexpr int kQgStages = 4;        // stages a warp has in flight
constexpr int kQgLaneBytes = 8;     // bytes of a W row a lane computes on
constexpr int kQgWarpBytes = 32 * kQgLaneBytes;
constexpr int kQgStageBytes = kQgRows * kQgWarpBytes;
constexpr int kQgRingBytes = kQgWarps * kQgStages * kQgStageBytes;

// The formats of a W row: kV columns in a lane's 8 bytes, kP rows of k per
// W row, kScaled whether columns carry scales; fma adds x(b, row) W(row,
// col + c) over the lane's columns (w: its 2 words of the row; x0 the rows
// of x at the W row, x1 at the next row of k, for int4's odd nibbles).
struct F32Row {
  static constexpr int kV = 2, kP = 1;
  static constexpr bool kScaled = false;
  template <int kMB>
  static __device__ __forceinline__ void fma(float (&acc)[kMB][kV],
                                             const unsigned (&w)[2],
                                             const float (&)[kV],
                                             const float (&x0)[kMB],
                                             const float (&)[kMB]) {
#pragma unroll
    for (int c = 0; c < kV; ++c) {
      const float e = __uint_as_float(w[c]);
#pragma unroll
      for (int b = 0; b < kMB; ++b) acc[b][c] = fmaf(x0[b], e, acc[b][c]);
    }
  }
};

struct Bf16Row {
  static constexpr int kV = 4, kP = 1;
  static constexpr bool kScaled = false;
  template <int kMB>
  static __device__ __forceinline__ void fma(float (&acc)[kMB][kV],
                                             const unsigned (&w)[2],
                                             const float (&)[kV],
                                             const float (&x0)[kMB],
                                             const float (&)[kMB]) {
#pragma unroll
    for (int c = 0; c < kV; ++c) {
      // a bf16 is the top half of the fp32 with the same value
      const unsigned u = w[c / 2];
      const float e = __uint_as_float(c % 2 ? u & 0xffff0000u : u << 16);
#pragma unroll
      for (int b = 0; b < kMB; ++b) acc[b][c] = fmaf(x0[b], e, acc[b][c]);
    }
  }
};

template <bool kBf16>
struct Int8Row {
  static constexpr int kV = 8, kP = 1;
  static constexpr bool kScaled = true;
  template <int kMB>
  static __device__ __forceinline__ void fma(float (&acc)[kMB][kV],
                                             const unsigned (&w)[2],
                                             const float (&sc)[kV],
                                             const float (&x0)[kMB],
                                             const float (&)[kMB]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const unsigned xw = w[i] ^ 0x80808080u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = dequant<kBf16>(s8_float(xw, c), sc[4 * i + c]);
#pragma unroll
        for (int b = 0; b < kMB; ++b)
          acc[b][4 * i + c] = fmaf(x0[b], e, acc[b][4 * i + c]);
      }
    }
  }
};

template <bool kBf16>
struct Int4Row {
  static constexpr int kV = 8, kP = 2;
  static constexpr bool kScaled = true;
  template <int kMB>
  static __device__ __forceinline__ void fma(float (&acc)[kMB][kV],
                                             const unsigned (&w)[2],
                                             const float (&sc)[kV],
                                             const float (&x0)[kMB],
                                             const float (&x1)[kMB]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
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
};

// Whether the kernel forms the rank partials (#1, #4) or not (#11).  Types,
// not a flag, so that a profile tells the two families apart by name.
struct NoRank {
  static constexpr bool kRank = false;
};
struct BankRank {
  static constexpr bool kRank = true;
};

struct GemvArgs {
  const void* x;      // (m, k), fp32 or (x_bf16) bf16
  int x_bf16;
  const uint8_t* wd;  // W's rows, row_bytes apart
  const float* ws;    // packed W's scales
  const void* a;      // (K, r, k) of x's type (BankRank)
  const int* ids;     // (m,) or nullptr (BankRank)
  float* out;         // (ksplit, m, n) partials, or y (ksplit 1, NoRank)
  float* p;           // (ksplit, m, r) rank partials (BankRank)
  int m, k, n, r, kchunk, group_shift;
};

// Copy bytes [c0, c0 + kQgWarpBytes) of W rows [row0, row0 + kQgRows)
// (none at or past rb; rows row_bytes long) into one stage of the warp's
// ring (row u at stage + u kQgWarpBytes): kLoad-byte pieces spread over
// the lanes, or (kLoad 1) this lane's kQgLaneBytes bytes of each row, zero
// past the row's end.
template <int kLoad>
__device__ __forceinline__ void fetch_stage(uint8_t* stage,
                                            const uint8_t* wd, int row0,
                                            int rb, int c0, int row_bytes,
                                            int lane) {
  if constexpr (kLoad == 1) {
    const int col = c0 + lane * kQgLaneBytes;
#pragma unroll
    for (int u = 0; u < kQgRows; ++u) {
      if (row0 + u >= rb) break;
      const uint8_t* src = wd + static_cast<size_t>(row0 + u) * row_bytes;
      unsigned w[2] = {0u, 0u};
#pragma unroll
      for (int c = 0; c < kQgLaneBytes; ++c)
        if (col + c < row_bytes)
          w[c / 4] |= static_cast<unsigned>(__ldg(src + col + c))
                      << (8 * (c % 4));
      *reinterpret_cast<uint2*>(stage + u * kQgWarpBytes +
                                lane * kQgLaneBytes) = make_uint2(w[0], w[1]);
    }
  } else {
    constexpr int kPerRow = kQgWarpBytes / kLoad;  // pieces of a row
#pragma unroll
    for (int i = 0; i < kQgRows * kPerRow / 32; ++i) {
      const int piece = lane + 32 * i;
      const int u = piece / kPerRow, off = (piece % kPerRow) * kLoad;
      // row_bytes is a multiple of kLoad: a piece lies in the row or past it
      if (row0 + u < rb && c0 + off < row_bytes)
        cp_async<kLoad>(
            stage + u * kQgWarpBytes + off,
            wd + static_cast<size_t>(row0 + u) * row_bytes + c0 + off);
    }
  }
}

// The 2 words of one row (in a stage) that hold this lane's columns.
__device__ __forceinline__ void read_words(const uint8_t* row, int lane,
                                           unsigned (&w)[2]) {
  const uint2 u = *reinterpret_cast<const uint2*>(row + lane * kQgLaneBytes);
  w[0] = u.x;
  w[1] = u.y;
}

// The scales of columns [col, col + kV) of one scale row, zero past n
// (vector loads where n is a multiple of 8 and the scales aligned).
template <bool kVecScales, int kV>
__device__ __forceinline__ void load_scales(const float* s, int col, int n,
                                            float (&sc)[kV]) {
  if constexpr (!kVecScales) {
#pragma unroll
    for (int c = 0; c < kV; ++c) sc[c] = col + c < n ? __ldg(s + col + c) : 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < kV / 4; ++i) {
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

// The rank partials of a chunk [k0, k1) and row group [b0, b0 + mg): p[chunk]
// [b0 + b][j] = sum_t xs[t][b] A[id_b, j, k0 + t], over its mg r pairs (b,
// j).  They are the work of the chunk's rank blocks (grid x past the column
// blocks), kRankBlockPairs pairs each: rank block rb takes pairs [rb
// kRankBlockPairs, + kRankBlockPairs), warp w of it pairs w, w + kQgWarps,
// ... of those, all kRankPairs of them at once (their loads in flight
// together); the lanes stride over the chunk (coalesced rows of A), then
// add in a fixed tree.
constexpr int kRankPairs = 4;  // pairs a warp of a rank block takes
constexpr int kRankBlockPairs = kQgWarps * kRankPairs;

template <int kMB, typename T>
__device__ __forceinline__ void rank_partials(const GemvArgs& g,
                                              const float* xs, int rb, int b0,
                                              int mg, int k0, int k1,
                                              int lane, int warp) {
  const T* a = static_cast<const T*>(g.a);
  const int npairs = mg * g.r, len = k1 - k0;
  const T* ar[kRankPairs];
  int xb[kRankPairs];
  float s[kRankPairs];
#pragma unroll
  for (int u = 0; u < kRankPairs; ++u) {
    // a pair past the last repeats pair 0 and is not written
    int q = rb * kRankBlockPairs + u * kQgWarps + warp;
    q = q < npairs ? q : 0;
    const int b = q / g.r, j = q % g.r;
    const int id = g.ids ? g.ids[b0 + b] : b0 + b;
    ar[u] = a + (static_cast<size_t>(id) * g.r + j) * g.k + k0;
    xb[u] = b;
    s[u] = 0.f;
  }
#pragma unroll 2
  for (int t = lane; t < len; t += 32) {
    T av[kRankPairs];
#pragma unroll
    for (int u = 0; u < kRankPairs; ++u) av[u] = ldg(ar[u] + t);
#pragma unroll
    for (int u = 0; u < kRankPairs; ++u)
      s[u] = fmaf(xs[t * kMB + xb[u]], to_f(av[u]), s[u]);
  }
#pragma unroll
  for (int u = 0; u < kRankPairs; ++u) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    const int q = rb * kRankBlockPairs + u * kQgWarps + warp;
    if (lane == 0 && q < npairs)
      g.p[(static_cast<size_t>(blockIdx.y) * g.m + b0 + q / g.r) * g.r +
          q % g.r] = s[u];
  }
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): columns [blockIdx.x kWarpCols,
// + kWarpCols), rows [k0, k1) of k with k0 = blockIdx.y kchunk, rows of x
// [b0, b0 + kMB) with b0 = blockIdx.z kMB, into out[blockIdx.y][b][j].
// Warp w walks its share of the chunk's W rows, contiguous, through its
// ring; lane l computes columns [l kV, + kV) of the block's.  With the rank
// term (BankRank) the blocks past the last column block are the chunk's
// rank blocks instead: they stage x as well, and form rank partials while
// the column blocks stream W.  Dynamic shared memory: the rings, then x's
// chunk.
template <int kMB, int kLoad, class F, class R>
__global__ void __launch_bounds__(kQgWarps * 32)
gemv_kernel(const GemvArgs g) {
  constexpr int kV = F::kV, kP = F::kP;
  constexpr int kWarpCols = 32 * kV;
  constexpr int kColBytes = kQgLaneBytes / kV;  // bytes of a column in a row
  extern __shared__ float4 qg_smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(qg_smem4);
  float* xs = reinterpret_cast<float*>(ring + kQgRingBytes);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = g.m, k = g.k, n = g.n, kchunk = g.kchunk;
  // < 0 in a column block, else which of the chunk's rank blocks
  const int rank_block =
      static_cast<int>(blockIdx.x) - (n + kWarpCols - 1) / kWarpCols;
  const int row_bytes = n * kColBytes;
  const int c0 = blockIdx.x * kWarpCols, col = c0 + lane * kV;
  const int k0 = blockIdx.y * kchunk, k1 = min(k, k0 + kchunk);
  const int b0 = blockIdx.z * kMB, mg = min(kMB, m - b0);
  // this warp's W rows [ra, rb) of the chunk's [k0 / kP, ceil(k1 / kP))
  const int r0 = k0 / kP, r1 = (k1 + kP - 1) / kP;
  const int per = (r1 - r0 + kQgWarps - 1) / kQgWarps;
  const int ra = min(r1, r0 + warp * per), rb = min(r1, ra + per);
  const int nsteps = (rb - ra + kQgRows - 1) / kQgRows;
  uint8_t* wring = ring + warp * kQgStages * kQgStageBytes;

  // the first stages' loads and the first scale row, in flight while the
  // block stages x
#pragma unroll
  for (int st = 0; st < kQgStages - 1; ++st) {
    if (st < nsteps && rank_block < 0)
      fetch_stage<kLoad>(wring + st * kQgStageBytes, g.wd, ra + st * kQgRows,
                         rb, c0 * kColBytes, row_bytes, lane);
    cp_async_commit();
  }
  float sc[kV];
  int grp = (kP * ra) >> g.group_shift;  // the scale row sc holds (int4)
  if constexpr (F::kScaled)
    if (col < n && ra < rb)
      load_scales<kLoad != 1>(
          g.ws + static_cast<size_t>(kP == 2 ? grp : 0) * n, col, n, sc);

  // xs[t kMB + b] = x[b0 + b, k0 + t] as fp32, zero past k1 and past the
  // group's rows: all of a thread's loads (at most kMB x 4) issued before
  // its first store
  constexpr int kT = kQgMaxChunk / (kQgWarps * 32);
  float xv[kMB][kT];
#pragma unroll
  for (int b = 0; b < kMB; ++b)
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int t = threadIdx.x + j * kQgWarps * 32;
      xv[b][j] = 0.f;
      if (b < mg && k0 + t < k1) {
        const size_t at = static_cast<size_t>(b0 + b) * k + k0 + t;
        xv[b][j] = g.x_bf16 ? __bfloat162float(
                                  static_cast<const __nv_bfloat16*>(g.x)[at])
                            : static_cast<const float*>(g.x)[at];
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

  if constexpr (R::kRank) {
    // the pass may launch now: it waits for this grid before it reads
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    if (rank_block >= 0) {
      if (g.x_bf16)
        rank_partials<kMB, __nv_bfloat16>(g, xs, rank_block, b0, mg, k0, k1,
                                          lane, warp);
      else
        rank_partials<kMB, float>(g, xs, rank_block, b0, mg, k0, k1, lane,
                                  warp);
      return;
    }
  }

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
      fetch_stage<kLoad>(wring + (nx % kQgStages) * kQgStageBytes, g.wd,
                         ra + nx * kQgRows, rb, c0 * kColBytes, row_bytes,
                         lane);
    cp_async_commit();
    if (col >= n) continue;
    const uint8_t* cur = wring + (it % kQgStages) * kQgStageBytes;
#pragma unroll
    for (int u = 0; u < kQgRows; ++u) {
      const int row = ra + it * kQgRows + u;
      if (row >= rb) break;
      if constexpr (kP == 2) {
        const int gr = (kP * row) >> g.group_shift;
        if (gr != grp) {  // the warp's rows entered the next scale group
          grp = gr;
          load_scales<kLoad != 1>(g.ws + static_cast<size_t>(gr) * n, col, n,
                                  sc);
        }
      }
      unsigned w[2];
      read_words(cur + u * kQgWarpBytes, lane, w);
      const float* xr = xs + (kP * row - k0) * kMB;
      float x0[kMB], x1[kMB];
      load_x<kMB>(xr, x0);
      if constexpr (kP == 2) load_x<kMB>(xr + kMB, x1);
      F::template fma<kMB>(acc, w, sc, x0, kP == 2 ? x1 : x0);
    }
  }
  cp_async_wait<0>();

  // the warps' sums, added in warp order through shared memory (the rings),
  // up to 4 rows of x at a time
  constexpr int kRedRows = kMB < 4 ? kMB : 4;
  __syncthreads();  // every warp is done with its ring
  float* red = reinterpret_cast<float*>(ring);  // [row][warp][kWarpCols]
  static_assert(kRedRows * kQgWarps * kWarpCols * sizeof(float) <=
                    kQgRingBytes,
                "the reduction fits in the rings");
#pragma unroll
  for (int rr = 0; rr < kMB; rr += kRedRows) {
    if (rr >= mg) break;
#pragma unroll
    for (int u = 0; u < kRedRows; ++u) {
      float* dst = red + (u * kQgWarps + warp) * kWarpCols + lane * kV;
      if constexpr (kV % 4 == 0) {
#pragma unroll
        for (int i = 0; i < kV / 4; ++i)
          reinterpret_cast<float4*>(dst)[i] =
              make_float4(acc[rr + u][4 * i], acc[rr + u][4 * i + 1],
                          acc[rr + u][4 * i + 2], acc[rr + u][4 * i + 3]);
      } else {
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[rr + u][0], acc[rr + u][1]);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kRedRows * kWarpCols; e += kQgWarps * 32) {
      const int u = e / kWarpCols, c = e % kWarpCols, j = c0 + c;
      if (rr + u < mg && j < n) {
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < kQgWarps; ++q)
          sum += red[(u * kQgWarps + q) * kWarpCols + c];
        g.out[(static_cast<size_t>(blockIdx.y) * m + b0 + rr + u) * n + j] =
            sum;
      }
    }
    __syncthreads();
  }
}

template <int kMB, int kLoad, class F, class R>
int launch(const GemvArgs& g, int ksplit, cudaStream_t st) {
  constexpr size_t kMaxSmem = kQgRingBytes + sizeof(float) * kQgMaxChunk * kMB;
  // once per instantiation, at the first (eager) call: later calls may be
  // captured into a CUDA graph, where the attribute call does not belong
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemv_kernel<kMB, kLoad, F, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  constexpr int kWarpCols = 32 * F::kV;
  const size_t smem = kQgRingBytes + sizeof(float) * g.kchunk * kMB;
  const int rows = g.m < kMB ? g.m : kMB;  // of the largest row group
  const int rank_blocks =
      R::kRank ? (rows * g.r + kRankBlockPairs - 1) / kRankBlockPairs : 0;
  const dim3 grid((g.n + kWarpCols - 1) / kWarpCols + rank_blocks, ksplit,
                  (g.m + kMB - 1) / kMB);
  gemv_kernel<kMB, kLoad, F, R><<<grid, kQgWarps * 32, smem, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// The row format: packed int8 / int4 (bits 8 / 4; bf16w rounds each element
// to bf16), or (bits 0, #1 only) dense of x's type.
template <int kMB, int kLoad, class R>
int by_format(const GemvArgs& g, int ksplit, int bits, int bf16w,
              cudaStream_t st) {
  if (bits == 8)
    return bf16w ? launch<kMB, kLoad, Int8Row<true>, R>(g, ksplit, st)
                 : launch<kMB, kLoad, Int8Row<false>, R>(g, ksplit, st);
  if (bits == 4)
    return bf16w ? launch<kMB, kLoad, Int4Row<true>, R>(g, ksplit, st)
                 : launch<kMB, kLoad, Int4Row<false>, R>(g, ksplit, st);
  if constexpr (R::kRank) {
    if (bits == 0)
      return g.x_bf16 ? launch<kMB, kLoad, Bf16Row, R>(g, ksplit, st)
                      : launch<kMB, kLoad, F32Row, R>(g, ksplit, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// 16-byte loads where W's rows and the scales allow them, else 8, else
// single bytes (rows of an odd byte length)
template <int kMB, class R>
int by_load(const GemvArgs& g, int ksplit, int bits, int bf16w,
            cudaStream_t st) {
  const int col_bytes = bits ? 1 : (g.x_bf16 ? 2 : 4);
  const long long row_bytes = static_cast<long long>(g.n) * col_bytes;
  const bool scales16 = bits == 0 || is_aligned(g.ws, 16);
  if (row_bytes % 16 == 0 && is_aligned(g.wd, 16) && scales16)
    return by_format<kMB, 16, R>(g, ksplit, bits, bf16w, st);
  if (row_bytes % 8 == 0 && is_aligned(g.wd, 8) && scales16)
    return by_format<kMB, 8, R>(g, ksplit, bits, bf16w, st);
  return by_format<kMB, 1, R>(g, ksplit, bits, bf16w, st);
}

// the rows of x a block takes: m itself up to 8 (rounded up to 1, 2, 4 or
// 8), groups of 8 beyond
template <class R>
int by_rows(const GemvArgs& g, int ksplit, int bits, int bf16w,
            cudaStream_t st) {
  if (g.m == 1) return by_load<1, R>(g, ksplit, bits, bf16w, st);
  if (g.m == 2) return by_load<2, R>(g, ksplit, bits, bf16w, st);
  if (g.m <= 4) return by_load<4, R>(g, ksplit, bits, bf16w, st);
  return by_load<8, R>(g, ksplit, bits, bf16w, st);
}

bool bad_plan(int m, int k, int ksplit, int kchunk) {
  return m < 1 || k < 1 || kchunk <= 0 || kchunk % kQgSlab != 0 ||
         kchunk > kQgMaxChunk || ksplit < 1 ||
         static_cast<long long>(ksplit) * kchunk < k ||
         static_cast<long long>(ksplit - 1) * kchunk >= k;
}

// #1 / #4's second pass: out[b, c] = sum_q partial[q][b][c] + sum_j (sum_q
// p[q][b][j]) B[id_b, c, j], every sum over q in chunk order.  Block
// (blockIdx.x, b): kPassCols columns of row b, one a thread, and one more
// warp that meanwhile sums p[., b, :] into shared memory; each sum keeps
// the loads of kPassBatch chunks in flight at once, and a thread's first
// kPassB elements of B are loaded before them.
constexpr int kPassCols = 256;
constexpr int kPassBatch = 16;
constexpr int kPassB = 8;

template <typename F>
__device__ __forceinline__ float chunk_sum(int ksplit, F v) {
  float s = 0.f;
  int q = 0;
  for (; q + kPassBatch <= ksplit; q += kPassBatch) {
    float f[kPassBatch];
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) f[u] = v(q + u);
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) s += f[u];
  }
  for (; q < ksplit; ++q) s += v(q);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kPassCols + 32)
bgmv_pass_kernel(const float* __restrict__ partial, const float* __restrict__ p,
                 const T* __restrict__ bm, const int* __restrict__ ids,
                 float* __restrict__ out, int m, int n, int r, int ksplit) {
  extern __shared__ float pb[];  // (r,): p[b, :] over all chunks
  const int b = blockIdx.y;
  const int c = blockIdx.x * kPassCols + threadIdx.x;
  const bool col = threadIdx.x < kPassCols && c < n;
  const T* br = bm + (static_cast<size_t>(ids ? ids[b] : b) * n + c) * r;
  float bv[kPassB];
#pragma unroll
  for (int j = 0; j < kPassB; ++j)
    bv[j] = col && j < r ? to_f(ldg(br + j)) : 0.f;
  float acc = 0.f;
  // launched while the GEMV runs (programmatic stream serialization): wait
  // for it, and for its writes, before reading what it wrote
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (threadIdx.x >= kPassCols) {
    for (int j = threadIdx.x - kPassCols; j < r; j += 32)
      pb[j] = chunk_sum(ksplit, [&](int q) {
        return __ldg(p + (static_cast<size_t>(q) * m + b) * r + j);
      });
  } else if (col) {
    acc = chunk_sum(ksplit, [&](int q) {
      return __ldg(partial + (static_cast<size_t>(q) * m + b) * n + c);
    });
  }
  __syncthreads();
  if (!col) return;
  float lora = 0.f;
#pragma unroll
  for (int j = 0; j < kPassB; ++j)
    if (j < r) lora = fmaf(pb[j], bv[j], lora);
#pragma unroll 8
  for (int j = kPassB; j < r; ++j)
    lora = fmaf(pb[j], to_f(ldg(br + j)), lora);
  out[static_cast<size_t>(b) * n + c] = acc + lora;
}

template <typename T>
int bgmv_pass(const float* partial, const float* p, const void* b,
              const int* ids, float* out, int m, int n, int r, int ksplit,
              cudaStream_t st) {
  // programmatic dependent launch: the pass's blocks launch (and load B)
  // while the GEMV's last blocks run, and wait for it in the kernel
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kPassCols - 1) / kPassCols, m);
  cfg.blockDim = dim3(kPassCols + 32);
  cfg.dynamicSmemBytes = sizeof(float) * r;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, bgmv_pass_kernel<T>, partial, p, static_cast<const T*>(b), ids,
      out, m, n, r, ksplit));
}

}  // namespace

int qgemv_partial(const void* x, bool x_bf16, const void* wd, const float* ws,
                  float* out, int m, int k, int n, int ksplit, int kchunk,
                  int bits, int group, int bf16w, cudaStream_t st) {
  if (bad_plan(m, k, ksplit, kchunk) || m > kQgMaxRows ||
      (bits != 8 && bits != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  GemvArgs g{};
  g.x = x;
  g.x_bf16 = x_bf16 ? 1 : 0;
  g.wd = static_cast<const uint8_t*>(wd);
  g.ws = ws;
  g.out = out;
  g.m = m;
  g.k = k;
  g.n = n;
  g.kchunk = kchunk;
  g.group_shift = bits == 4 ? log2_group(group) : 0;
  return by_rows<NoRank>(g, ksplit, bits, bf16w, st);
}

int bgmv_gemv_body(const void* x, bool x_bf16, const void* wd,
                   const float* ws, const void* a, const void* b,
                   const int* ids, float* p, float* partial, float* out,
                   int m, int k, int n, int r, int ksplit, int kchunk,
                   int bits, int group, int bf16w, cudaStream_t st) {
  if (bad_plan(m, k, ksplit, kchunk) || r < 1 || r > kQgMaxRank ||
      (bits != 8 && bits != 4 && bits != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  GemvArgs g{};
  g.x = x;
  g.x_bf16 = x_bf16 ? 1 : 0;
  g.wd = static_cast<const uint8_t*>(wd);
  g.ws = ws;
  g.a = a;
  g.ids = ids;
  g.out = partial;
  g.p = p;
  g.m = m;
  g.k = k;
  g.n = n;
  g.r = r;
  g.kchunk = kchunk;
  g.group_shift = bits == 4 ? log2_group(group) : 0;
  const int err = by_rows<BankRank>(g, ksplit, bits, bf16w, st);
  if (err != 0) return err;
  return x_bf16 ? bgmv_pass<__nv_bfloat16>(partial, p, b, ids, out, m, n, r,
                                           ksplit, st)
                : bgmv_pass<float>(partial, p, b, ids, out, m, n, r, ksplit,
                                   st);
}

}  // namespace repro_kernels
