// The LoRA gradient reductions #7 and #8, for Hopper (sm_90a):
//   lora_bwd_da_launch <- _bwd_da_kernel  dA = gamma q^T x   (r, k)
//   lora_bwd_db_launch <- _bwd_db_kernel  dB = gamma g^T p   (n, r)
// of src/repro/kernels/lora_matmul.py (:201 via _bwd_da_call, :230 via
// _bwd_db_call), with x (m, k) and g (m, n) fp32 or bf16, p and q (m, r)
// fp32, outputs fp32; accumulation is fp32 FMA on the CUDA cores (no TF32).
// Both are one body,
//   out[i, j] = gamma sum_t L[t, i] R[t, j],   L (m, ni), R (m, nj),
// with L = q, R = x for dA and L = g, R = p for dB: both operands row-major
// and contiguous along the output index, so a slab of 16 t rows is 16
// contiguous row segments of each.
//
// What bounds them on an H100 at the training path's shapes (m = 512, k =
// 2048, n = 2048 (q) or 256 (v), r = 64): operations, 2 m r k (134 MFLOP,
// 2.00 us at 67 TFLOP/s fp32) for dA and 2 m n r for dB; x's 4 MB alone
// take 1.25 us at 3.35 TB/s.  The TPU kernels walk m on a sequential grid
// into an output block it revisits.  The outputs hold few tiles (32 of 64 x
// 64 for dA, 4 for dB at v), so one block per tile walking all of m would
// leave most SMs idle.  So:
//   - m is split into c <= 16 chunks of whole 16-row slabs (the host's plan,
//     kernels/common.py reduce_plan), one CTA per (tile, chunk); the c CTAs
//     of a tile form a thread-block cluster (grid (tiles_j, tiles_i, c),
//     cluster (1, 1, c); above 8, the portable size, the kernel is allowed
//     non-portable clusters).
//   - Each CTA contracts its chunk through a 3-stage ring of slabs that
//     16-byte cp.async fills (bf16 staged as it is and widened when read),
//     256 threads with 4 x 4 outputs each, one float4 of L and one of R per
//     16 FMAs; a warp's loads are 4 and 8 distinct 16-byte words, one
//     wavefront each.
//   - The chunks' partial tiles meet in distributed shared memory: rank z
//     of the cluster owns a 1/c share of the tile's outputs, every CTA
//     stores its partial of that share into slot `rank` of z's inbox, one
//     cluster barrier, and z adds its c slots in rank order 0..c-1, scales
//     by gamma and writes the share once.  The barrier's other half (every
//     CTA has started) is an arrival at the kernel's start, waited for
//     after the contraction.  No global partial buffer, no second kernel,
//     no atomics: two calls are bit-identical.  With c = 1 a CTA writes its
//     tile directly from its registers.
// It replaced a 64 x 64 tile with element-wise register staging and
// 2 FMAs per shared load, whose chunks wrote fp32 partials to global memory
// (4 MB at q against a 512 KB output) for a second kernel to add (PERF.md).
// Ragged edges are masked; off the vector conditions (ni and nj multiples
// of a 16-byte copy's elements, aligned operands) the scalar path stages
// element by element.  Nothing is padded.
//
// Plain C interface, bound with ctypes (kernels/build.py,
// kernels/lora_matmul.py).  Each entry point launches on the caller's
// stream, does not synchronise, allocates nothing, asks the device nothing
// (capture-safe), and returns the launch's error or cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "loaders.cuh"

namespace {

using repro_kernels::as_f4;
using repro_kernels::cp_async;
using repro_kernels::cp_async_commit;
using repro_kernels::cp_async_wait;
using repro_kernels::is_aligned;
using repro_kernels::ldg;

constexpr int kGB = 64;          // output rows and columns per tile
constexpr int kGK = 16;          // t rows per slab
constexpr int kGThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kGStages = 3;      // slabs in the ring
constexpr int kGMaxCluster = 16;  // the non-portable cluster size

// One operand's slab of tile columns [c0, c0 + kGB) and t rows [t0, t0 +
// kGK) into buf[tt][c] (kGB elements a row, of the operand's own type).
// Vector: 16-byte cp.async copies straight into buf (zeros outside).
// Scalar: element loads into registers (fetch), written after the FMAs
// (store).
template <typename E, bool kVec>
struct Stager {
  static constexpr int kPer = kVec ? 16 / static_cast<int>(sizeof(E)) : 1;
  static constexpr int kPerRow = kGB / kPer;       // copies per slab row
  static constexpr int kCopies = kGK * kPerRow;    // copies per slab
  static constexpr int kN = (kCopies + kGThreads - 1) / kGThreads;
  const E* p;  // (m, ld) row-major
  int ld;      // its columns: the output extent this operand spans
  int c0;
  E v[kN];

  __device__ __forceinline__ void fetch(int t0, int t_hi, E* buf) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int idx = threadIdx.x + e * kGThreads;
      if (kCopies % kGThreads != 0 && idx >= kCopies) continue;
      const int tt = idx / kPerRow, c = (idx % kPerRow) * kPer;
      const int t = t0 + tt, j = c0 + c;
      const bool in = t < t_hi && j < ld;
      const E* src = in ? p + static_cast<size_t>(t) * ld + j : p;
      if constexpr (kVec)
        cp_async<16>(buf + tt * kGB + c, src, in);
      else
        v[e] = in ? ldg(src) : E(0.f);
    }
  }
  __device__ __forceinline__ void store(E* buf) const {
    if constexpr (!kVec) {
#pragma unroll
      for (int e = 0; e < kN; ++e) buf[threadIdx.x + e * kGThreads] = v[e];
    }
  }
};

// 4 consecutive elements of a slab row as fp32
__device__ __forceinline__ float4 ld4f(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}
__device__ __forceinline__ float4 ld4f(const __nv_bfloat16* s) {
  return as_f4(*reinterpret_cast<const uint2*>(s));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// acc[a][b] += sum over the slab of ls[tt][4 ti + a] rs[tt][4 tj + b]: one
// float4 of each operand per 16 FMAs.  A warp spans 4 ti x 8 tj: its L
// loads hit 4 words of one 64-byte span, its R loads 8 words of one
// 128-byte line.
template <typename EL, typename ER>
__device__ __forceinline__ void micro(float (&acc)[4][4], const EL* ls,
                                      const ER* rs, int ti, int tj) {
#pragma unroll
  for (int tt = 0; tt < kGK; ++tt) {
    const float4 l4 = ld4f(ls + tt * kGB + 4 * ti);
    const float4 r4 = ld4f(rs + tt * kGB + 4 * tj);
    const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
    const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(lv[a], rv[b], acc[a][b]);
  }
}

// out[row, col .. col + 3] = v, masked at ni x nj; vec: one float4 store
__device__ __forceinline__ void put4(float* out, int ni, int nj, bool vec,
                                     int row, int col, float4 v) {
  if (row >= ni || col >= nj) return;
  float* o = out + static_cast<size_t>(row) * nj + col;
  if (vec) {
    *reinterpret_cast<float4*>(o) = v;
  } else {
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col + c < nj) o[c] = f[c];
  }
}

// The cluster barrier, split: arrive (relaxed: orders nothing; release:
// this thread's earlier writes, distributed shared memory included, are
// seen by whoever waits after it) and wait (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// *p = v in the shared memory of CTA rank of the cluster, at the offset p
// has in this CTA's
__device__ __forceinline__ void st_cluster(float4* p, unsigned rank,
                                           float4 v) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   remote),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

constexpr int kQuads = kGB * kGB / 4;  // float4s of a tile
// shared memory: the ring, and apart from it the cluster's inbox: c shares
// of ceil(kQuads / c) float4s, one per rank
constexpr int kInboxBytes = (kQuads + kGMaxCluster - 1) * 16;
template <typename EL, typename ER>
__host__ __device__ constexpr int ring_bytes() {
  return kGStages * kGK * kGB * static_cast<int>(sizeof(EL) + sizeof(ER));
}
template <typename EL, typename ER>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<EL, ER>() + kInboxBytes;
}

// Grid (tiles_j, tiles_i, c), cluster (1, 1, c) when c > 1: CTA z of a
// tile contracts t in [z chunk, min(m, (z + 1) chunk)).  Up to 128
// registers a thread, so that two CTAs share an SM.
template <typename EL, typename ER, bool kVec>
__global__ void __launch_bounds__(kGThreads, 2)
lora_grad_kernel(const EL* __restrict__ l, const ER* __restrict__ r,
                 float* __restrict__ out, int m, int ni, int nj, int chunk,
                 float gamma) {
  constexpr int kLElems = kGK * kGB;
  constexpr int kStageBytes = kLElems * static_cast<int>(sizeof(EL) +
                                                         sizeof(ER));
  extern __shared__ float4 grad_smem4[];
  char* smem = reinterpret_cast<char*>(grad_smem4);
  const int c = static_cast<int>(gridDim.z);
  // every CTA of the cluster has started before any writes into another's
  // inbox: the wait that completes this arrival comes after the
  // contraction
  if (c > 1) cluster_arrive_relaxed();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a warp: 4 ti x 8 tj
  const int tj = (warp & 1) * 8 + (lane & 7);
  const int ti = (warp >> 1) * 4 + (lane >> 3);
  const int i0 = blockIdx.y * kGB, j0 = blockIdx.x * kGB;
  const int t_lo = blockIdx.z * chunk;
  const int t_hi = min(m, t_lo + chunk);
  const int nslab = t_hi > t_lo ? (t_hi - t_lo + kGK - 1) / kGK : 0;
  Stager<EL, kVec> ls{l, ni, i0};
  Stager<ER, kVec> rs{r, nj, j0};
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  // slab it + kGStages - 1 is requested before slab it's FMAs (and, on the
  // scalar path, written after them) into the stage slab it - 1 used
#pragma unroll
  for (int st = 0; st < kGStages - 1; ++st) {
    if (st < nslab) {
      char* sb = smem + st * kStageBytes;
      EL* lb = reinterpret_cast<EL*>(sb);
      ER* rb = reinterpret_cast<ER*>(sb + kLElems * sizeof(EL));
      ls.fetch(t_lo + st * kGK, t_hi, lb);
      rs.fetch(t_lo + st * kGK, t_hi, rb);
      ls.store(lb);
      rs.store(rb);
    }
    cp_async_commit();
  }
  int rd = 0, wr = kGStages - 1;
  for (int it = 0; it < nslab; ++it) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();
    char* nb = smem + wr * kStageBytes;
    EL* nlb = reinterpret_cast<EL*>(nb);
    ER* nrb = reinterpret_cast<ER*>(nb + kLElems * sizeof(EL));
    const bool more = it + kGStages - 1 < nslab;
    if (more) {
      const int t0 = t_lo + (it + kGStages - 1) * kGK;
      ls.fetch(t0, t_hi, nlb);
      rs.fetch(t0, t_hi, nrb);
    }
    cp_async_commit();
    const char* cb = smem + rd * kStageBytes;
    micro(acc, reinterpret_cast<const EL*>(cb),
          reinterpret_cast<const ER*>(cb + kLElems * sizeof(EL)), ti, tj);
    if (more) {
      ls.store(nlb);
      rs.store(nrb);
    }
    rd = rd + 1 == kGStages ? 0 : rd + 1;
    wr = wr + 1 == kGStages ? 0 : wr + 1;
  }
  cp_async_wait<0>();

  const bool vec =
      nj % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto row4 = [&](int a) {
    return make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  };
  if (c == 1) {  // no split: the registers are the sums
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 s = row4(a);
      put4(out, ni, nj, vec, i0 + 4 * ti + a, j0 + 4 * tj,
           make_float4(gamma * s.x, gamma * s.y, gamma * s.z, gamma * s.w));
    }
    return;
  }

  // rank z owns float4s [z share, (z + 1) share) of the tile (row-major,
  // kGB / 4 a row); each CTA puts its partial of them into slot `rank` of
  // z's inbox
  const int share = (kQuads + c - 1) / c;
  const int rank = static_cast<int>(blockIdx.z);
  float4* inbox = reinterpret_cast<float4*>(smem + ring_bytes<EL, ER>());
  cluster_wait();  // every CTA of the cluster has started
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int q = (4 * ti + a) * (kGB / 4) + tj;
    const int owner = q / share;
    st_cluster(inbox + rank * share + (q - owner * share), owner, row4(a));
  }
  cluster_arrive();
  cluster_wait();  // every partial is in its owner's inbox
  const int lo = rank * share, hi = min(kQuads, lo + share);
  for (int q = lo + static_cast<int>(threadIdx.x); q < hi; q += kGThreads) {
    float4 s = inbox[q - lo];
    for (int z = 1; z < c; ++z) s = add4(s, inbox[z * share + q - lo]);
    put4(out, ni, nj, vec, i0 + q / (kGB / 4), j0 + (q % (kGB / 4)) * 4,
         make_float4(gamma * s.x, gamma * s.y, gamma * s.z, gamma * s.w));
  }
}

template <typename EL, typename ER, bool kVec>
int grad_launch(const EL* l, const ER* r, float* out, int m, int ni, int nj,
                int c, int chunk, float gamma, cudaStream_t st) {
  // once per instantiation, at the first (eager) call: later calls may be
  // captured into a CUDA graph, where the attribute call does not belong
  static bool wide_set = false;
  if (!wide_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        lora_grad_kernel<EL, ER, kVec>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    wide_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nj + kGB - 1) / kGB, (ni + kGB - 1) / kGB, c);
  cfg.blockDim = dim3(kGThreads);
  cfg.dynamicSmemBytes = smem_bytes<EL, ER>();
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = c;
  cfg.attrs = attr;
  cfg.numAttrs = c > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, lora_grad_kernel<EL, ER, kVec>, l, r, out, m, ni, nj, chunk,
      gamma);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// out (ni, nj) = gamma L^T R over the host's plan: c chunks of chunk rows
// (kernels/common.py reduce_plan), which must cover m.  The vector path
// needs rows of whole 16-byte copies and 16-byte aligned operands.
template <typename EL, typename ER>
int grads(const void* lp, const void* rp, float* out, int m, int ni, int nj,
          int c, int chunk, float gamma, cudaStream_t st) {
  if (c < 1 || c > kGMaxCluster || chunk < 1 ||
      static_cast<long long>(c) * chunk < m)
    return static_cast<int>(cudaErrorInvalidValue);
  const EL* l = static_cast<const EL*>(lp);
  const ER* r = static_cast<const ER*>(rp);
  constexpr int kPL = 16 / sizeof(EL), kPR = 16 / sizeof(ER);
  if (ni % kPL == 0 && nj % kPR == 0 && is_aligned(l, 16) &&
      is_aligned(r, 16))
    return grad_launch<EL, ER, true>(l, r, out, m, ni, nj, c, chunk, gamma,
                                     st);
  return grad_launch<EL, ER, false>(l, r, out, m, ni, nj, c, chunk, gamma,
                                    st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x).  q: (m, r) fp32; da: (r, k) fp32.
// The m loop runs in c chunks of chunk rows (kernels/common.py
// reduce_plan), one cluster of c CTAs a 64 x 64 tile of dA.
int lora_bwd_da_launch(const float* q, const void* x, float* da, int m,
                       int k, int r, int c, int chunk, float gamma,
                       int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return grads<float, float>(q, x, da, m, r, k, c, chunk, gamma, st);
  if (dtype == 1)
    return grads<float, __nv_bfloat16>(q, x, da, m, r, k, c, chunk, gamma,
                                       st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// g of the dtype (m, n); p: (m, r) fp32; db: (n, r) fp32; the plan as for
// dA.
int lora_bwd_db_launch(const void* g, const float* p, float* db, int m,
                       int n, int r, int c, int chunk, float gamma,
                       int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return grads<float, float>(g, p, db, m, n, r, c, chunk, gamma, st);
  if (dtype == 1)
    return grads<__nv_bfloat16, float>(g, p, db, m, n, r, c, chunk, gamma,
                                       st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of c CTAs of the fp32 kernel (vector path) the card
// can hold at once (cudaOccupancyMaxActiveClusters), or minus the CUDA
// error.  Asks the device: for a report, not for a wrapper.
int lora_grads_max_clusters(int c) {
  const cudaError_t set = cudaFuncSetAttribute(
      lora_grad_kernel<float, float, true>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (set != cudaSuccess) return -static_cast<int>(set);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, c);
  cfg.blockDim = dim3(kGThreads);
  cfg.dynamicSmemBytes = smem_bytes<float, float>();
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = c;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &clusters, lora_grad_kernel<float, float, true>, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : clusters;
}

}  // extern "C"
