// Paged-attention decode for Hopper (sm_90a): a split-table kernel with a
// fixed-order merge.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/paged_attention.py:
//   paged_attention_launch <- _paged_attn_kernel (paged_attention, :45)
// One query token per request attends over the request's blocks of a
// shared KV pool, named by the request's row of the block table:
//   q (B, h, hd); k_pool, v_pool (P, bs, kh, hd); pos_pool (P, bs) int32
//   (-1 = never written); table (B, mb) int32; qpos (B,) int32;
//   out (B, h, hd) in q's type.  q, the pools and out are fp32 or bf16.
// Position p of pool block table[i, j] is attendable iff
//   0 <= p <= qpos[i]   (and qpos[i] - p < window when window > 0);
// scores are (q . k) * scale, then softcap * tanh(s / softcap) when
// softcap > 0, and NEG_INF where not attendable; a running (m, l, acc)
// softmax walks the positions, with p = 0 where the score is NEG_INF and l
// clamped at 1e-30 in the final division: the arithmetic of
// paged_attention.py:56-84.
//
// What bounds it on an H100: bytes, and at the paths' shapes latency.  The
// K and V a decode step may attend (B = 4, kh = 1, hd = 256: 1.1 MB at the
// gemma-2b path's 160 positions, 14.7 MB at 2048) take 0.3-4.4 us at
// 3.35 TB/s; 16 query heads on one kv head do about 8 FLOP per fp32 byte,
// under the fp32 ridge of about 20, so fp32 FMA on the CUDA cores suffices
// (TF32 would gain nothing and break the fp32 tolerance).  The TPU kernel
// walks a request's blocks in a sequential grid dimension and carries (m,
// l, acc) in VMEM; its first port here did the same with one CUDA block
// per (request, kv head): 4 blocks on 132 SMs, each walking its columns
// with three barriers and scalar loads per column (143 us at the gemma-2b
// path, PERF.md).  This design:
//   - fills the card: the grid is (request, kv head, chunk), chunk z takes
//     table columns [z c, (z + 1) c), with (nsplit, c) planned on the host
//     from (B, kh, mb) and the SM count alone (kernels/common.py
//     paged_split: about one block per SM).  Each block carries the
//     running (m, l, acc) of its kv head's g query heads over its own
//     columns and writes them as fp32 partials; paged_merge_kernel
//     combines a request's nsplit partials in z order (m = max m_z, l =
//     sum l_z e^(m_z - m), acc likewise, out = acc / max(l, 1e-30)): no
//     atomics, so a run repeats bit for bit.  A chunk with no attendable
//     position (m = NEG_INF, l = 0) adds nothing; a request with none at
//     all gets zeros.  With nsplit = 1 the block writes out directly and
//     the merge is not launched.
//   - streams K and V: positions are staged in sub-blocks of up to kSub
//     (the host's P, smaller only where a large head would not fit), so no
//     block size is refused; a kStages-deep ring in shared memory, filled
//     by 16-byte cp.async (element copies where rows are not 16-byte
//     aligned), keeps sub-blocks s + 1 .. s + 3 in flight while s
//     computes (4 columns of K and V at the long context: a block's whole
//     chunk is requested at once).  There the phases of each sub-block
//     (scores, softmax, p V; a barrier each), not the bytes, set the time
//     (PERF.md).
//   - reads each staged K and V element once per block, not once per head:
//     scores are 4 heads x 4 positions a tile, 16 lanes splitting hd in
//     float4 quads of q (staged once per block with the first sub-block)
//     and K, reduced across the lanes by a butterfly; the running softmax
//     takes a half-warp per head; p V is 4 heads x 4 dims a thread from
//     float4 reads of V and of p, added to acc once per sub-block.
// Idle engine slots point every table entry at the null block 0; the
// kernel reads it like any other block (their outputs are discarded).  A
// table entry outside [0, P) stops the kernel with a device-side trap (as
// PyTorch's own index kernels assert on the device), so checking the table
// costs no host synchronisation.  hd, bs and g need no particular
// multiple: ragged quads, heads and positions are zero-padded or masked.
// fp32 FMA throughout, full-precision expf and tanhf (no fast math).
// Plain C interface, bound with ctypes (kernels/build.py,
// kernels/paged_attention.py); launches on the caller's stream, does not
// synchronise, allocates nothing (the partials' scratch is the caller's),
// and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstdio>

#include "loaders.cuh"

namespace {

using repro_kernels::to_f;

constexpr int kThreads = 256;
constexpr int kSub = 16;     // most positions a sub-block stages
constexpr int kStages = 4;   // sub-blocks in the shared-memory ring
constexpr int kSlices = 16;  // lanes that split hd for one score tile
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// sum and max over the 16 lanes of a half-warp (the positions of a
// sub-block)
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One step of the score tiles' butterfly: the 16 lanes of a tile hold 16
// partial sums each (2 kHalf of them live); lanes kHalf apart swap halves
// and add, so each keeps kHalf sums of twice as many lanes.  After the
// steps 8, 4, 2, 1, lane sl holds element sl summed over all 16 lanes.
template <int kHalf>
__device__ __forceinline__ void fold(float (&v)[16], int sl) {
  const bool up = sl & kHalf;
#pragma unroll
  for (int e = 0; e < kHalf; ++e) {
    const float send = up ? v[e] : v[e + kHalf];
    const float keep = up ? v[e + kHalf] : v[e];
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

// 4 consecutive staged elements as fp32: a float4, or 4 bf16 in 8 bytes
__device__ __forceinline__ float4 quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 quad(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  // a bf16 is the top half of the fp32 with the same value
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The shared-memory layout of one block (kernels/paged_attention.py _smem
// mirrors it): the ring (kStages x K, V x P rows of ldk elements of T), q
// (g rows of ldq elements of T), then fp32 acc (g x hq4), the
// probabilities (kSub x g4), the scores (g4 x kSub), m, l and corr (g4
// each), and pos (kStages x kSub int32).  g4 = g rounded up to 4 heads,
// hq4 = hd to 4 elements (ldq to 8 for bf16, so rows stay 16-byte
// aligned); a ring row is padded by 16 bytes, so rows 4 banks apart feed
// one score tile.
template <typename T>
struct Layout {
  int g, g4, hq, hq4, ldk, ldq, P;
  __host__ __device__ Layout(int g_, int hd, int P_)
      : g(g_),
        g4((g_ + 3) / 4 * 4),
        hq((hd + 3) / 4),
        hq4(hq * 4),
        ldk(sizeof(T) == 4 ? hq4 + 4 : (hq4 + 7) / 8 * 8 + 8),
        ldq(sizeof(T) == 4 ? hq4 : (hq4 + 7) / 8 * 8),
        P(P_) {}
  __host__ __device__ size_t ring_elems() const {
    return static_cast<size_t>(kStages) * 2 * P * ldk;
  }
  __host__ __device__ size_t floats() const {
    return static_cast<size_t>(g) * hq4 + 2 * g4 * kSub + 3 * g4 +
           kStages * kSub;
  }
  __host__ __device__ size_t bytes() const {
    return (ring_elems() + static_cast<size_t>(g) * ldq) * sizeof(T) +
           floats() * sizeof(float);
  }
};

// Grid (B, kh, nsplit); block z walks table columns [z c, min((z + 1) c,
// mb)) in sub-blocks of P positions.  nsplit == 1: writes out; otherwise
// part[((i kh + kv) nsplit + z) g + gi][0, hd + 2) = (acc, m, l).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
                   const int* __restrict__ pos_pool,
                   const int* __restrict__ table,
                   const int* __restrict__ qpos, T* __restrict__ out,
                   float* __restrict__ part, int npool, int h, int kh, int hd,
                   int bs, int mb, int cols, int P, int window,
                   float softcap, float scale) {
  extern __shared__ float4 pa_smem4[];
  const int g = h / kh;
  const Layout<T> L(g, hd, P);
  const int g4 = L.g4, hq = L.hq, hq4 = L.hq4, ldk = L.ldk, ldq = L.ldq;
  T* ring = reinterpret_cast<T*>(pa_smem4);
  T* qs = ring + L.ring_elems();
  float* acc = reinterpret_cast<float*>(qs + static_cast<size_t>(g) * ldq);
  float* pr = acc + g * hq4;  // [t][gi]
  float* sc = pr + kSub * g4;  // [gi][t]
  float* m = sc + g4 * kSub;
  float* l = m + g4;
  float* corr = l + g4;
  int* pos_s = reinterpret_cast<int*>(corr + g4);  // [stage][t]

  const int i = blockIdx.x, kv = blockIdx.y, z = blockIdx.z;
  const int nsplit = gridDim.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int qp = qpos[i];
  const int c_lo = z * cols, c_hi = min(mb, c_lo + cols);
  const int nsub = (bs + P - 1) / P;  // sub-blocks a column
  const int nsubs = max(0, c_hi - c_lo) * nsub;

  // query heads kv * g .. kv * g + g - 1 are contiguous in q and out; q
  // lands with the first sub-block's copies
  const size_t head0 = (static_cast<size_t>(i) * h + kv * g) * hd;
  if constexpr (kVec) {
    constexpr int kE = 16 / sizeof(T);  // elements a 16-byte copy
    for (int e = tid; e < g * hd / kE; e += kThreads) {
      const int gi = e / (hd / kE), c = e % (hd / kE);
      cp_async16(qs + gi * ldq + c * kE, q + head0 + gi * hd + c * kE);
    }
  } else {
    for (int e = tid; e < g * hq4; e += kThreads) {
      const int gi = e / hq4, d = e % hq4;
      qs[gi * ldq + d] = d < hd ? q[head0 + gi * hd + d] : T(0.f);
    }
  }
  for (int e = tid; e < g * hq4; e += kThreads) acc[e] = 0.f;
  for (int e = tid; e < kSub * g4; e += kThreads) pr[e] = 0.f;
  for (int e = tid; e < g4; e += kThreads) {
    m[e] = kNegInf;
    l[e] = 0.f;
    corr[e] = 0.f;
  }

  // the table entry of sub-block s (a load), and the same checked against
  // the pool (uniform across the block)
  const auto entry_of = [&](int s) {
    return s < nsubs ? table[static_cast<size_t>(i) * mb + c_lo + s / nsub]
                     : 0;
  };
  const auto checked = [&](int entry, int s) {
    if (entry < 0 || entry >= npool) {
      if (tid == 0)
        printf("paged_attention: table[%d, %d] = %d outside the pool of %d "
               "blocks\n", i, c_lo + s / nsub, entry, npool);
      __trap();
    }
    return entry;
  };
  // stage sub-block s of pool block `entry`: its pos, K and V rows
  const auto issue = [&](int s, int entry) {
    const int st = s % kStages, o = (s % nsub) * P, np = min(P, bs - o);
    const size_t row0 = static_cast<size_t>(entry) * bs + o;
    if (tid < np) cp_async4(pos_s + st * kSub + tid, pos_pool + row0 + tid);
    T* kd = ring + static_cast<size_t>(st) * 2 * P * ldk;
    if constexpr (kVec) {
      constexpr int kE = 16 / sizeof(T);  // elements a 16-byte copy
      const int cpr = hd / kE;  // copies a row
      for (int e = tid; e < 2 * np * cpr; e += kThreads) {
        const int row = e / cpr, c = e - row * cpr;  // K rows, then V rows
        const bool v = row >= np;
        const int t = v ? row - np : row;
        const T* src = (v ? v_pool : k_pool) +
                       ((row0 + t) * kh + kv) * hd + c * kE;
        cp_async16(kd + (v * P + t) * ldk + c * kE, src);
      }
    } else {
      for (int e = tid; e < 2 * np * hq4; e += kThreads) {
        const int row = e / hq4, d = e - row * hq4;  // K rows, then V rows
        const bool v = row >= np;
        const int t = v ? row - np : row;
        const T* src = (v ? v_pool : k_pool) + ((row0 + t) * kh + kv) * hd;
        kd[(v * P + t) * ldk + d] = d < hd ? src[d] : T(0.f);
      }
    }
  };

  // sub-blocks 0 .. kStages - 2 in flight, one commit group each (q joins
  // the first); their table entries are loaded together first
  int ent[kStages];
#pragma unroll
  for (int s = 0; s < kStages; ++s) ent[s] = entry_of(s);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsubs) issue(s, checked(ent[s], s));
    cp_async_commit();
  }
  int next = ent[kStages - 1];
  for (int s = 0; s < nsubs; ++s) {
    // every thread finished sub-block s - 1 (the barrier ending it), so
    // its stage may be refilled with s + kStages - 1
    if (s + kStages - 1 < nsubs)
      issue(s + kStages - 1, checked(next, s + kStages - 1));
    cp_async_commit();
    next = entry_of(s + kStages);  // in flight during s
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int st = s % kStages, np = min(P, bs - (s % nsub) * P);
    const T* ks = ring + static_cast<size_t>(st) * 2 * P * ldk;
    const T* vs = ks + static_cast<size_t>(P) * ldk;
    const int* ps = pos_s + st * kSub;

    // scores: tile (head block hb, position block pb) of 4 x 4, 16 lanes
    // (slice sl) each over quads sl, sl + 16, ... of hd
    const int p4 = (np + 3) / 4, ntile = g4 / 4 * p4;
    const int sl = tid % kSlices;
    constexpr int kTiles = kThreads / kSlices;  // tiles a pass
    for (int tile = tid / kSlices;
         tile < (ntile + kTiles - 1) / kTiles * kTiles; tile += kTiles) {
      const int hb = tile / p4, pb = tile % p4;
      float v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = 0.f;
      if (tile < ntile) {
#pragma unroll 4
        for (int dq = sl; dq < hq; dq += kSlices) {
          float4 qv[4], kq[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            qv[a] = hb * 4 + a < g ? quad(qs + (hb * 4 + a) * ldq + dq * 4)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
            const int t = pb * 4 + a;
            kq[a] = t < np ? quad(ks + t * ldk + dq * 4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              float& d = v[a * 4 + u];
              d = fmaf(qv[a].x, kq[u].x, d);
              d = fmaf(qv[a].y, kq[u].y, d);
              d = fmaf(qv[a].z, kq[u].z, d);
              d = fmaf(qv[a].w, kq[u].w, d);
            }
        }
      }
      // butterfly over the 16 slices: lane sl ends with element sl
      fold<8>(v, sl);
      fold<4>(v, sl);
      fold<2>(v, sl);
      fold<1>(v, sl);
      const int gi = hb * 4 + sl / 4, t = pb * 4 + sl % 4;
      if (tile < ntile && gi < g && t < np) {
        float sv = v[0] * scale;
        if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
        const int p = ps[t];
        bool valid = p >= 0 && p <= qp;
        if (window > 0) valid = valid && qp - p < window;
        sc[gi * kSub + t] = valid ? sv : kNegInf;
      }
    }
    __syncthreads();

    // running softmax: a half-warp per query head, a lane per position
    for (int g0 = 2 * warp; g0 < g; g0 += kThreads / 16) {
      const int gi = g0 + lane / 16, t = lane % 16;
      const bool on = gi < g, in = on && t < np;
      const float sv = in ? sc[gi * kSub + t] : kNegInf;
      const float m_prev = on ? m[gi] : kNegInf;
      const float m_new = fmaxf(m_prev, half_max(sv));
      const float p = sv <= kNegInf / 2 ? 0.f : expf(sv - m_new);
      if (in) pr[t * g4 + gi] = p;
      const float sum = half_sum(p);
      if (on && t == 0) {
        const float c = expf(m_prev - m_new);
        corr[gi] = c;
        l[gi] = l[gi] * c + sum;
        m[gi] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p V: 4 heads x one quad of dims a thread; a warp's
    // lanes take consecutive quads (V reads side by side, p broadcast)
    for (int item = tid; item < g4 / 4 * hq; item += kThreads) {
      const int hb = item / hq, dq = item % hq;
      float4 a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int t = 0; t < np; ++t) {
        const float4 vv = quad(vs + t * ldk + dq * 4);
        const float4 pp =
            *reinterpret_cast<const float4*>(pr + t * g4 + hb * 4);
        const float pa[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a[u].x = fmaf(pa[u], vv.x, a[u].x);
          a[u].y = fmaf(pa[u], vv.y, a[u].y);
          a[u].z = fmaf(pa[u], vv.z, a[u].z);
          a[u].w = fmaf(pa[u], vv.w, a[u].w);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int gi = hb * 4 + u;
        if (gi >= g) break;
        const float c = corr[gi];
        float4* dst = reinterpret_cast<float4*>(acc + gi * hq4 + dq * 4);
        float4 r = *dst;
        r.x = r.x * c + a[u].x;
        r.y = r.y * c + a[u].y;
        r.z = r.z * c + a[u].z;
        r.w = r.w * c + a[u].w;
        *dst = r;
      }
    }
    __syncthreads();
  }
  __syncthreads();  // acc, m and l are final (also when nsubs is 0)

  if (nsplit == 1) {
    for (int e = tid; e < g * hd; e += kThreads)
      out[head0 + e] = from_f<T>(acc[(e / hd) * hq4 + e % hd] /
                                 fmaxf(l[e / hd], 1e-30f));
    return;
  }
  float* dst = part + ((static_cast<size_t>(i) * kh + kv) * nsplit + z) * g *
                          (hd + 2);
  for (int e = tid; e < g * (hd + 2); e += kThreads) {
    const int gi = e / (hd + 2), d = e % (hd + 2);
    dst[e] = d < hd ? acc[gi * hq4 + d] : d == hd ? m[gi] : l[gi];
  }
}

// out[i, head, :] from a request's nsplit partials, combined in z order:
// one block per (request, query head).  The chunks' m and l go to shared
// memory while each thread loads the acc_z of its first dim for the first
// kMergeZ chunks into registers (one round trip to L2 at the paths'
// splits), then each chunk's weight e^(m_z - m) is formed once and the sums
// run in z order.
constexpr int kMergeZ = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                   int h, int kh, int hd, int nsplit) {
  extern __shared__ float mg_smem[];
  float* ms = mg_smem;      // m_z
  float* ls = ms + nsplit;  // l_z
  float* ws = ls + nsplit;  // e^(m_z - m)
  const int i = blockIdx.x / h, head = blockIdx.x % h;
  const int g = h / kh, kv = head / g, gi = head % g;
  const size_t stride = static_cast<size_t>(g) * (hd + 2);
  const float* p = part +
                   (static_cast<size_t>(i) * kh + kv) * nsplit * stride +
                   static_cast<size_t>(gi) * (hd + 2);
  for (int zz = threadIdx.x; zz < nsplit; zz += kThreads) {
    ms[zz] = p[zz * stride + hd];
    ls[zz] = p[zz * stride + hd + 1];
  }
  const int d0 = threadIdx.x;
  float av[kMergeZ];
#pragma unroll
  for (int zz = 0; zz < kMergeZ; ++zz)
    av[zz] = zz < nsplit && d0 < hd ? p[zz * stride + d0] : 0.f;
  __syncthreads();
  float mx = kNegInf;
  for (int zz = 0; zz < nsplit; ++zz) mx = fmaxf(mx, ms[zz]);
  for (int zz = threadIdx.x; zz < nsplit; zz += kThreads)
    ws[zz] = expf(ms[zz] - mx);
  __syncthreads();
  float lsum = 0.f;
  for (int zz = 0; zz < nsplit; ++zz) lsum += ls[zz] * ws[zz];
  const float den = fmaxf(lsum, 1e-30f);
  T* o = out + (static_cast<size_t>(i) * h + head) * hd;
  for (int d = d0; d < hd; d += kThreads) {
    float a = 0.f;
    int z = 0;
    if (d == d0) {  // the first kMergeZ chunks are in registers
#pragma unroll
      for (int zz = 0; zz < kMergeZ; ++zz)
        if (zz < nsplit) a += av[zz] * ws[zz];
      z = kMergeZ;
    }
    for (; z < nsplit; ++z) a += p[z * stride + d] * ws[z];
    o[d] = from_f<T>(a / den);
  }
}

template <typename T, bool kVec>
int launch_split(const T* q, const T* k_pool, const T* v_pool,
                 const int* pos_pool, const int* table, const int* qpos,
                 T* out, float* part, int b, int npool, int h, int kh, int hd,
                 int bs, int mb, int nsplit, int cols, int P, int window,
                 float softcap, float scale, cudaStream_t st) {
  const size_t smem = Layout<T>(h / kh, hd, P).bytes();
  // once per instantiation, at the first (eager) call: later calls may be
  // captured into a CUDA graph, where the attribute call does not belong
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<T, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  paged_split_kernel<T, kVec><<<dim3(b, kh, nsplit), kThreads, smem, st>>>(
      q, k_pool, v_pool, pos_pool, table, qpos, out, part, npool, h, kh, hd,
      bs, mb, cols, P, window, softcap, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  paged_merge_kernel<T><<<b * h, kThreads, 3 * nsplit * sizeof(float),
                          st>>>(part, out, h, kh, hd, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* pos_pool, const int* table, const int* qpos, void* out,
           float* part, int b, int npool, int h, int kh, int hd, int bs,
           int mb, int nsplit, int cols, int P, int window, float softcap,
           float scale, cudaStream_t st) {
  const T* kp = static_cast<const T*>(k_pool);
  const T* vp = static_cast<const T*>(v_pool);
  // 16-byte copies need every K and V row 16-byte aligned
  const bool vec = hd * sizeof(T) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  const auto f = vec ? launch_split<T, true> : launch_split<T, false>;
  return f(static_cast<const T*>(q), kp, vp, pos_pool, table, qpos,
           static_cast<T*>(out), part, b, npool, h, kh, hd, bs, mb, nsplit,
           cols, P, window, softcap, scale, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k_pool, v_pool and out).
// window <= 0: no sliding window; softcap <= 0: no soft cap.
// npool: the pools' block count P (table entries must lie in [0, P)).
// The table's columns split into nsplit chunks of cols (nsplit * cols >=
// mb, every chunk nonempty), staged P positions at a time (1 <= P <= 16);
// when nsplit > 1, part is a (B, kh, nsplit, h / kh, hd + 2) fp32 scratch
// for the chunks' partials, else unused.
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const int* pos_pool,
                           const int* table, const int* qpos, void* out,
                           float* part, int b, int npool, int h, int kh,
                           int hd, int bs, int mb, int nsplit, int cols, int P,
                           int window, float softcap, float scale, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P < 1 || P > kSub || nsplit < 1 || cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, pos_pool, table, qpos, out, part,
                         b, npool, h, kh, hd, bs, mb, nsplit, cols, P, window,
                         softcap, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, pos_pool, table, qpos,
                                 out, part, b, npool, h, kh, hd, bs, mb,
                                 nsplit, cols, P, window, softcap, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
