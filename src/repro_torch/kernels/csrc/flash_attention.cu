// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention_launch <- _kernel (flash_attention)
// q (bh, s, d); k, v (bkv, t, d) with bh = bkv * group: folded query head
// i reads key/value head i / group, which is the GQA expansion of
// ops.flash_mha (query heads of one kv head are neighbours in the fold)
// done as indexing instead of a materialised repeat.  fp32 or bf16 in,
// fp32 arithmetic, out (bh, s, d) in q's type.  With positions the row and
// column indices, a score (q . k) * scale is kept iff
//   k_pos < t,  and k_pos <= q_pos when causal,  and q_pos - k_pos < window
//   when window > 0;
// masked scores are NEG_INF = -1e30, p = 0 where a score is <= NEG_INF / 2,
// a running (m, l, acc) softmax walks the key tiles, and the output is
// acc / max(l, 1e-30): the arithmetic of flash_attention.py:22-58.
//
// The TPU kernel's grid (bh, nq, nk) walks key blocks in its innermost,
// sequential dimension and keeps (acc, m, l) in VMEM scratch.  GPU blocks
// run in no order, so one CUDA block owns one (folded head, 64-row query
// tile) and loops over 64-key tiles itself, with acc in registers.  Key
// tiles wholly outside the causal / window band are skipped: under the
// rules above such a tile leaves m, l and acc as they are.
//
// What bounds it on an H100: operations, 4 * bh * (attended pairs) * d
// FLOPs in fp32 (no TF32, porting hazard (b)): 1.54 ms at recurrentgemma-9b's
// local attention (bh 16, s = t = 4096, d 256, causal, window 2048), 0.26 ms
// at gemma-2b's (bh 8, s = t = 2048, causal), at the 67 TFLOP/s of the CUDA
// cores.  The scores stay out of device memory.  The kernel this design
// replaced ran at 20-30% of that peak (2.12x SDPA at gemma-2b, PERF.md): K
// and V staged by scalar loads between barriers, 2 x 4 scores a thread (5.3
// FMAs per shared load), P read as scalars, 141.6 KB of shared memory for
// one block of 8 warps per SM, three barriers per key tile.  Here:
//   - A block is two teams of 8 warps, one block an SM: 16 warps, at most
//     128 registers a thread.  Both teams read the query tile's Q (64 x D
//     fp32, resident in shared memory); each walks half of its key tiles
//     with its own ring, P and softmax state, and at the end the second
//     team's (m, l, acc) joins the first's in a fixed order.  A block takes
//     one query tile whole, so gemma-2b's longest causal tile (as much work
//     as an SM's share of the grid) keeps its SM's 16 warps busy; blocks
//     start longest first and the hardware hands the next block to the
//     first SM that frees.  (On an H100, two one-team blocks an SM, with
//     8 KB slabs to fit, ran recurrentgemma-9b 9% slower, and two teams
//     with 8 KB slabs gemma-2b 11% slower; PERF.md.)  The scalar path
//     (d % 4 != 0 or unaligned operands) takes one team a block: its
//     register staging needs more than 128 registers.
//   - Each team's K and V stream through a 3-stage shared-memory ring of 16
//     KB slabs (a K slab is 64 keys x 64 of d, a V slab 4096 / D keys x D;
//     8 KB on the scalar path), 205 KB of shared memory a block at D = 256,
//     filled with 16-byte cp.async.cg for fp32 operands (bf16 ones are
//     loaded into registers before a slab's FMAs and converted and stored
//     after them), two slabs ahead of the one the FMAs read.  Each stage has
//     two mbarriers: "full" completes when every thread's copies (or
//     stores) of the slab have landed, "empty" when every warp has read it,
//     so warps wait only for the data they read and the stage they refill.
//   - S = Q K^T: a thread owns 4 x 4 scores (rows r + 4 i, keys c + 8 j),
//     reads Q and K as float4: 8 loads per 64 FMAs, free of bank conflicts.
//   - O += P V: a thread owns 8 rows x D / 32 columns (8 x 8 at D = 256);
//     P lies [key][row] in shared memory, so a thread's 8 rows are two
//     float4: 4 loads per 64 FMAs.
//   - Two barriers per key tile, each over one team's 256 threads (named
//     barriers 1 and 2): after the row maxima (the two warps that share a
//     row exchange them) and after P.
//
// Plain C interface, bound with ctypes (kernels/build.py,
// kernels/flash_attention.py); launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "loaders.cuh"

namespace {

using repro_kernels::as_f4;
using repro_kernels::cp_async;
using repro_kernels::is_aligned;
using repro_kernels::ld4;
using repro_kernels::ldg;
using repro_kernels::to_f;
using repro_kernels::Vec4;

constexpr int kThreads = 256;        // threads of a team
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kStages = 3;
constexpr int kPLd = kBQ + 4;        // P row stride: P[key][row]
constexpr float kNegInf = -1e30f;

// D: head-dim capacity (64, 128 or 256); the runtime d <= D is zero-padded
// in shared memory and masked on output.  kTeams: teams of kThreads a
// block, with slabs of 16 KB for two teams, 8 KB for one.
template <int D, int kTeams>
struct Geo {
  static constexpr int kSlab = kTeams == 2 ? 4096 : 2048;  // floats a slab
  static constexpr int kKd = kSlab / kBK;        // columns of a K slab
  static constexpr int kKLd = kKd + 4;           // K slab row stride
  static constexpr int kStageF = kBK * kKLd;     // floats a ring stage holds
  static constexpr int kQLd = D + 4;             // Q row stride (floats)
  static constexpr int kVKeys = kSlab / D;       // keys a V slab holds
  static constexpr int kKSlabs = D / kKd;        // K slabs a key tile
  static constexpr int kSlabs = kKSlabs + kBK / kVKeys;
  static constexpr int kQF = kBQ * kQLd;
  // a team's ring, P and 8 per-row vectors (row maxima and sums of the two
  // key halves, m by tile parity, corr, l)
  static constexpr int kTeamF = kStages * kStageF + kBK * kPLd + 8 * kBQ;
  // Q, the teams' floats, then 2 mbarriers a stage a team
  static constexpr size_t kSmem =
      sizeof(float) * (kQF + kTeams * kTeamF) +
      2 * kStages * kTeams * sizeof(unsigned long long);
  // P V: a thread's D / 32 columns, kNG groups of kW consecutive ones
  static constexpr int kNC = D / 32;
  static constexpr int kW = kNC >= 4 ? 4 : kNC;
  static constexpr int kNG = kNC / kW;
};

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// arrive once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared.b64 state, [%0];\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}
// named barrier id (1 + team) over one team's kThreads threads
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "n"(kThreads)
               : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A thread's share of one ring slab of geometry G: kPer chunks of kW
// elements (16 bytes, or one element on the scalar path), the chunks of a
// key row side by side.  A K slab is 64 keys x kKd columns (kKd / kW
// chunks a row, stored [key][kKLd]), a V slab kVKeys keys x D (D / kW
// chunks a row, stored [key][D]); thread tid takes chunk tid % (chunks a
// row) of rows tid / (chunks a row) + e (kThreads / chunks a row), e <
// kPer.  Its row offset, column and stage offset are fixed per thread, so
// a fill costs a bound check and an address per chunk.
template <class G, int D, bool kVec>
struct SlabShare {
  static constexpr int kW = kVec ? 4 : 1;
  static constexpr int kPer = G::kSlab / kW / kThreads;
  static constexpr int kKc = G::kKd / kW, kVc = D / kW;  // chunks a row
  int kkey, kcol, vkey, vcol;
  __device__ __forceinline__ explicit SlabShare(unsigned tid)
      : kkey(tid / kKc), kcol(tid % kKc * kW), vkey(tid / kVc),
        vcol(tid % kVc * kW) {}
};

// kVec: d % 4 == 0 and q, k, v aligned for 4-element loads; two teams
// there, one elsewhere.  Block r takes query tile nq - 1 - r / bh (the
// longest under a causal mask first) of head r % bh.
template <int D, typename T, bool kVec>
__global__ void __launch_bounds__((kVec ? 2 : 1) * kThreads, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int bh, int s,
             int t, int d, int group, int causal, int window, float scale,
             int nq) {
  constexpr int kTeams = kVec ? 2 : 1;
  using G = Geo<D, kTeams>;
  constexpr int kKd = G::kKd, kKLd = G::kKLd, kStageF = G::kStageF;
  constexpr bool kAsync = kVec && std::is_same<T, float>::value;
  constexpr int kW = kVec ? 4 : 1;
  constexpr int kQLd = G::kQLd, kNC = G::kNC, kCW = G::kW, kNG = G::kNG;
  using Raw = typename std::conditional<kVec, typename Vec4<T>::U, T>::type;

  const int team = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* teams = Qs + G::kQF;
  float* ring = teams + team * G::kTeamF;
  float* Ps = ring + kStages * kStageF;
  float* redm = Ps + kBK * kPLd;  // [key half][row]: partial row maxima
  float* reds = redm + 2 * kBQ;   // [key half][row]: partial row sums
  float* mrow = reds + 2 * kBQ;   // [tile parity][row]: running max
  float* crow = mrow + 2 * kBQ;   // [row]: this tile's rescale factor
  float* lrow = crow + kBQ;       // [row]: running sum
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(teams + kTeams * G::kTeamF) +
      team * 2 * kStages;
  unsigned long long* empty = full + kStages;

  const int rank = blockIdx.x;
  const int head = rank % bh;
  const int q0 = (nq - 1 - rank / bh) * kBQ;
  const T* qb = q + static_cast<size_t>(head) * s * d;
  const T* kb = k + static_cast<size_t>(head / group) * t * d;
  const T* vb = v + static_cast<size_t>(head / group) * t * d;

  const int lane = tid & 31, warp = tid >> 5;
  // S = Q K^T: warp (16-row band, 32-key half), lane (row group, key
  // group); a thread's scores are rows srow + 4 i, keys scol + 8 j
  const int kh = warp & 1, kg = lane & 7;
  const int srow = (warp >> 1) * 16 + (lane >> 3);
  const int scol = kh * 32 + kg;
  // O += P V: rows r0 .. r0 + 7, columns g D / kNG + c4 kCW + (0 .. kCW)
  const int r0 = (warp >> 2) * 32 + (lane >> 3) * 8;
  const int c4 = (warp & 3) * 8 + (lane & 7);

  // the band of key positions any row of this tile can attend, in tiles;
  // team 0 walks the first half of them, team 1 the rest
  const int q_last = min(q0 + kBQ, s) - 1;
  const int k_hi = causal ? min(t - 1, q_last) : t - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int all = k_lo <= k_hi ? k_hi / kBK - k_lo / kBK + 1 : 0;
  const int first = (all + kTeams - 1) / kTeams;
  const int kt0 = k_lo / kBK + team * first;
  const int ntiles = team == 0 ? first : all - first;
  const int nslab = ntiles * G::kSlabs;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + st, kThreads);
      mbar_init(empty + st, kWarps);
    }
  }
  for (int e = tid; e < kBQ; e += kThreads) {
    mrow[e] = kNegInf;  // parity 0: the first tile's
    lrow[e] = 0.f;
  }
  for (int idx = threadIdx.x; idx < kBQ * D / kW;
       idx += kTeams * kThreads) {
    const int row = idx / (D / kW), c = (idx % (D / kW)) * kW;
    const int gr = q0 + row;
    const bool in = gr < s && c < d;
    const T* src = qb + static_cast<size_t>(gr) * d + c;
    if constexpr (kVec)
      *reinterpret_cast<float4*>(Qs + row * kQLd + c) = as_f4(ld4(src, in));
    else
      Qs[row * kQLd + c] = in ? to_f(ldg(src)) : 0.f;
  }
  __syncthreads();  // barriers initialised, Q and the row vectors written

  // The ring, two slabs ahead of the one the FMAs read.  fetch(n) starts
  // slab n (cp.async, or loads into u) and store(n) finishes a register
  // fetch; both wait, before they write the stage, until every warp of the
  // team has read the slab it held before.  A slab's copies are issued
  // after the FMAs of the slab before it (not among them, which would hold
  // their addresses in registers beside the accumulators).  Slab n is K
  // slab sl or V slab sl - kKSlabs of key tile kt0 + n / kSlabs.
  using Share = SlabShare<G, D, kVec>;
  constexpr int kPer = Share::kPer;
  Raw u[kPer];
  // the stage offset of this thread's chunk e of slab n, and its source
  // (null past t or d)
  const auto chunk = [&](unsigned n, int e, int& off) -> const T* {
    const Share sh(tid);
    const unsigned sl = n % G::kSlabs;
    const bool is_k = sl < G::kKSlabs;
    const int key = is_k ? sh.kkey + e * (kThreads / Share::kKc)
                         : sh.vkey + e * (kThreads / Share::kVc);
    off = is_k ? key * kKLd + sh.kcol : key * D + sh.vcol;
    const int col = is_k ? sh.kcol + sl * kKd : sh.vcol;
    const int row = (kt0 + static_cast<int>(n / G::kSlabs)) * kBK + key +
                    (is_k ? 0 : (sl - G::kKSlabs) * G::kVKeys);
    return row < t && col < d
               ? (is_k ? kb : vb) + static_cast<size_t>(row) * d + col
               : nullptr;
  };
  const auto fetch = [&](int n) {
    const int st = n % kStages;
    if constexpr (kAsync) {
      if (n >= kStages) mbar_wait(empty + st, (n / kStages - 1) & 1);
      float* dst = ring + st * kStageF;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        int off;
        const T* src = chunk(n, e, off);
        cp_async<16>(dst + off, src ? src : kb, src != nullptr);
      }
      mbar_arrive_copies(full + st);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        int off;
        const T* src = chunk(n, e, off);
        if constexpr (kVec)
          u[e] = ld4(src, src != nullptr);
        else
          u[e] = src ? ldg(src) : T(0.f);
      }
    }
  };
  const auto store = [&](int n) {
    if constexpr (!kAsync) {
      const int st = n % kStages;
      if (n >= kStages) mbar_wait(empty + st, (n / kStages - 1) & 1);
      float* dst = ring + st * kStageF;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        int off;
        chunk(n, e, off);
        if constexpr (kVec)
          *reinterpret_cast<float4*>(dst + off) = as_f4(u[e]);
        else
          dst[off] = to_f(u[e]);
      }
      mbar_arrive(full + st);
    }
  };
  // the stage of slab n, once it has landed
  const auto acquire = [&](int n) {
    mbar_wait(full + n % kStages, (n / kStages) & 1);
    return ring + (n % kStages) * kStageF;
  };
  // this warp is done with slab n: finish slab n + 1, start slab n + 2
  const auto release = [&](int n) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + n % kStages);
    if (n + 1 < nslab) store(n + 1);
    if (n + 2 < nslab) fetch(n + 2);
  };

  float acc[8][kNC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[i][c] = 0.f;

  int n = 0;  // the next slab to read
  if (nslab > 0) {
    fetch(0);
    store(0);
  }
  if (nslab > 1) fetch(1);
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = (kt0 + it) * kBK;
    const int par = it & 1;

    // S = Q K^T over the K slabs
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int ks = 0; ks < G::kKSlabs; ++ks, ++n) {
      const float* kst = acquire(n);
      const float* qst = Qs + ks * kKd;
#pragma unroll
      for (int dd = 0; dd < kKd; dd += 4) {
        float4 qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(
              qst + (srow + 4 * i) * kQLd + dd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(
              kst + (scol + 8 * j) * kKLd + dd);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float a = sc[i][j];
            a = fmaf(qv[i].x, kv.x, a);
            a = fmaf(qv[i].y, kv.y, a);
            a = fmaf(qv[i].z, kv.z, a);
            a = fmaf(qv[i].w, kv.w, a);
            sc[i][j] = a;
          }
        }
      }
      release(n);
    }

    // mask; the row maxima of each key half (a row's 32 keys of a half sit
    // in the 8 lanes that share its row group)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + srow + 4 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + scol + 8 * j;
        bool valid = kpos < t;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && qpos - kpos < window;
        sc[i][j] = valid ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (kg == 0) redm[kh * kBQ + srow + 4 * i] = mx;
    }
    team_sync(team);  // both halves' maxima are in redm

    // p, its row sums, and the rescale factor of the running softmax
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = srow + 4 * i;
      const float m_prev = mrow[par * kBQ + row];
      const float m_new =
          fmaxf(m_prev, fmaxf(redm[row], redm[kBQ + row]));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            sc[i][j] <= kNegInf / 2 ? 0.f : expf(sc[i][j] - m_new);
        Ps[(scol + 8 * j) * kPLd + row] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (kg == 0) reds[kh * kBQ + row] = sum;
      if (kh == 0 && kg == 0) {
        crow[row] = expf(m_prev - m_new);
        mrow[(par ^ 1) * kBQ + row] = m_new;
      }
    }
    team_sync(team);  // P, the sums and corr are written

    // acc = acc * corr + P V over the V slabs; l = l * corr + sum, by one
    // thread a row
    {
      const float4 c0 = *reinterpret_cast<const float4*>(crow + r0);
      const float4 c1 = *reinterpret_cast<const float4*>(crow + r0 + 4);
      const float corr[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < kNC; ++c) acc[i][c] *= corr[i];
      if (c4 == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          lrow[r0 + i] = lrow[r0 + i] * corr[i] + reds[r0 + i] +
                         reds[kBQ + r0 + i];
      }
    }
    for (int vs = 0; vs < kBK / G::kVKeys; ++vs, ++n) {
      const float* vst = acquire(n);
#pragma unroll
      for (int jj = 0; jj < G::kVKeys; ++jj) {
        const float* prow = Ps + (vs * G::kVKeys + jj) * kPLd + r0;
        const float4 p0 = *reinterpret_cast<const float4*>(prow);
        const float4 p1 = *reinterpret_cast<const float4*>(prow + 4);
        const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int g = 0; g < kNG; ++g) {
          const float* vp = vst + jj * D + g * (D / kNG) + c4 * kCW;
          float vv[kCW];
          if constexpr (kCW == 4) {
            const float4 f = *reinterpret_cast<const float4*>(vp);
            vv[0] = f.x;
            vv[1] = f.y;
            vv[2] = f.z;
            vv[3] = f.w;
          } else {
            const float2 f = *reinterpret_cast<const float2*>(vp);
            vv[0] = f.x;
            vv[1] = f.y;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int c = 0; c < kCW; ++c)
              acc[i][g * kCW + c] = fmaf(p[i], vv[c], acc[i][g * kCW + c]);
        }
      }
      release(n);
    }
  }
  // Both teams are done with Q, and every l of the last tiles is written.
  // Team 1 leaves its acc in Q's place ([row][D]); team 0 joins the two
  // running softmaxes, out = (acc0 a0 + acc1 a1) / max(l0 a0 + l1 a1,
  // 1e-30) with a = exp(m - max(m0, m1)), and writes the tile.  With one
  // team, or a team 1 that had no key tile (m1 = -1e30, l1 = 0, acc1 = 0),
  // this is acc0 / max(l0, 1e-30).
  __syncthreads();
  float* acc1 = Qs;
  if (team == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int g = 0; g < kNG; ++g)
#pragma unroll
        for (int c = 0; c < kCW; ++c)
          acc1[(r0 + i) * D + g * (D / kNG) + c4 * kCW + c] =
              acc[i][g * kCW + c];
  }
  if constexpr (kTeams == 2) __syncthreads();
  if (team == 1) return;
  const float* other = teams + G::kTeamF;  // team 1's floats
  const float* mrow1 = other + kStages * kStageF + kBK * kPLd + 4 * kBQ;
  const float* lrow1 = mrow1 + 3 * kBQ;
  const int par0 = ntiles & 1, par1 = (all - first) & 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = q0 + r0 + i;
    if (gr >= s) continue;
    const int row = r0 + i;
    const float m0 = mrow[par0 * kBQ + row];
    const float m1 = kTeams == 2 ? mrow1[par1 * kBQ + row] : kNegInf;
    const float l1 = kTeams == 2 ? lrow1[row] : 0.f;
    const float m = fmaxf(m0, m1);
    const float a0 = expf(m0 - m), a1 = expf(m1 - m);
    const float den = fmaxf(lrow[row] * a0 + l1 * a1, 1e-30f);
    T* orow = out + (static_cast<size_t>(head) * s + gr) * d;
#pragma unroll
    for (int g = 0; g < kNG; ++g)
#pragma unroll
      for (int c = 0; c < kCW; ++c) {
        const int col = g * (D / kNG) + c4 * kCW + c;
        const float o1 = kTeams == 2 ? acc1[row * D + col] : 0.f;
        if (col < d)
          orow[col] = from_f<T>((acc[i][g * kCW + c] * a0 + o1 * a1) / den);
      }
  }
}

// One block per (query tile, head), longest first.
template <int D, typename T, bool kVec>
int launch_d(const void* q, const void* k, const void* v, void* out, int bh,
             int s, int t, int d, int group, int causal, int window,
             float scale, cudaStream_t st) {
  constexpr int kTeams = kVec ? 2 : 1;
  constexpr size_t smem = Geo<D, kTeams>::kSmem;
  const auto kernel = flash_kernel<D, T, kVec>;
  // once per instantiation, at the first (eager) call: later calls may be
  // captured into a CUDA graph, where the attribute call does not belong
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int nq = (s + kBQ - 1) / kBQ;
  kernel<<<nq * bh, kTeams * kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), bh, s, t, d, group,
      causal, window, scale, nq);
  return static_cast<int>(cudaGetLastError());
}

// The vector path when d and the operands allow it.
template <int D, typename T>
int launch_v(const void* q, const void* k, const void* v, void* out, int bh,
             int s, int t, int d, int group, int causal, int window,
             float scale, cudaStream_t st) {
  constexpr size_t kAlign = std::is_same<T, float>::value ? 16 : 8;
  if (d % 4 == 0 && is_aligned(q, kAlign) && is_aligned(k, kAlign) &&
      is_aligned(v, kAlign))
    return launch_d<D, T, true>(q, k, v, out, bh, s, t, d, group, causal,
                                window, scale, st);
  return launch_d<D, T, false>(q, k, v, out, bh, s, t, d, group, causal,
                               window, scale, st);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int s, int t, int d, int group, int causal, int window,
           float scale, cudaStream_t st) {
  if (d <= 64)
    return launch_v<64, T>(q, k, v, out, bh, s, t, d, group, causal, window,
                           scale, st);
  if (d <= 128)
    return launch_v<128, T>(q, k, v, out, bh, s, t, d, group, causal,
                            window, scale, st);
  if (d <= 256)
    return launch_v<256, T>(q, k, v, out, bh, s, t, d, group, causal,
                            window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  bh = bkv * group
// <= 65535; 1 <= d <= 256; window <= 0: no sliding window; causal 0 / 1.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int bh, int s, int t, int d, int group,
                           int causal, int window, float scale, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, bh, s, t, d, group, causal, window,
                         scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, bh, s, t, d, group, causal,
                                 window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
