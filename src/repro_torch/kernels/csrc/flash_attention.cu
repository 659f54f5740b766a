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
// tile) and loops over 32-row key/value tiles itself, with acc in registers
// and m, l in shared memory.  Key tiles wholly outside the causal / window
// band are skipped: under the rules above such a tile leaves m, l and acc
// as they are, so skipping it changes nothing.  Query tiles run last to
// first, so the longest (most key tiles under a causal mask) start first.
//
// What bounds it on an H100: operations, 4 * bh * (attended pairs) * d
// FLOPs in fp32 (no TF32, porting hazard (b)): 1.54 ms at recurrentgemma-9b's
// local attention (bh 16, s = t = 4096, d 256, causal, window 2048) at the
// 67 TFLOP/s of the CUDA cores.  The design keeps the (s, t) scores out of
// device memory (only q, k, v and the output move) and register-tiles both
// products: a thread computes 2 x 4 scores from float4 rows of Q and K in
// shared memory, and owns (d / 32) x 8 accumulators of the P V product.
// With d = 256 the tiles take 141.6 KB of shared memory (Q 64 x 260, K
// 32 x 260, V 32 x 256, P^T 32 x 64 floats, m / l / corr), so one block of
// 8 warps runs per SM; more warps per SM (smaller tiles, Q in registers)
// or wgmma on bf16 tiles is the next design.
//
// Plain C interface, bound with ctypes (kernels/build.py,
// kernels/flash_attention.py); launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "loaders.cuh"

namespace {

using repro_kernels::to_f;

constexpr int kThreads = 256, kBQ = 64, kBK = 32;
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared memory, in floats, for head-dim capacity D.
template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBQ) * (D + 4) + kBK * (D + 4) + kBK * D +
         kBK * kBQ + 3 * kBQ;
}

// D: head-dim capacity (64, 128 or 256); the runtime d <= D is zero-padded
// in shared memory and masked on output.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int s, int t,
             int d, int group, int causal, int window, float scale) {
  constexpr int LD = D + 4;            // Q and K row stride (16-byte rows)
  constexpr int NCT = D / 8;           // P V: threads along the columns
  constexpr int RPT = kBQ * NCT / kThreads;  // P V: rows per thread
  static_assert(RPT * (kThreads / NCT) == kBQ, "P V thread layout");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Pt = Vs + kBK * D;            // probabilities, [key][row]
  float* mrow = Pt + kBK * kBQ;
  float* lrow = mrow + kBQ;
  float* crow = lrow + kBQ;

  const int tid = threadIdx.x;
  const int head = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const T* qb = q + static_cast<size_t>(head) * s * d;
  const T* kb = k + static_cast<size_t>(head / group) * t * d;
  const T* vb = v + static_cast<size_t>(head / group) * t * d;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D, gr = q0 + r;
    Qs[r * LD + c] = (gr < s && c < d)
                         ? to_f(__ldg(qb + static_cast<size_t>(gr) * d + c))
                         : 0.f;
  }
  for (int e = tid; e < kBQ; e += kThreads) {
    mrow[e] = kNegInf;
    lrow[e] = 0.f;
  }

  // the band of key positions any row of this tile can attend
  const int q_last = min(q0 + kBQ, s) - 1;
  const int k_hi = causal ? min(t - 1, q_last) : t - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  // scores: thread (ty, tx) owns rows 2 ty, 2 ty + 1 and columns tx + 8 j
  const int ty = tid >> 3, tx = tid & 7;
  // P V: thread (ry, cx) owns rows ry * RPT .. + RPT - 1 and columns
  // cx * 4 .. + 3 and D / 2 + cx * 4 .. + 3
  const int ry = tid / NCT, cx = tid % NCT;
  const int r0 = ry * RPT;
  float acc[RPT][8];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int kt = k_lo / kBK; k_lo <= k_hi && kt <= k_hi / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D, gk = k0 + r;
      const bool ok = gk < t && c < d;
      const size_t g = static_cast<size_t>(gk) * d + c;
      Ks[r * LD + c] = ok ? to_f(__ldg(kb + g)) : 0.f;
      Vs[r * D + c] = ok ? to_f(__ldg(vb + g)) : 0.f;
    }
    __syncthreads();

    float sc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      float4 qv[2], kv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (2 * ty + i) * LD + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * LD + dd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

    // mask, then the running softmax; a row's 32 scores sit in the 8
    // neighbouring lanes that share ty
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * ty + i, qpos = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 8 * j;
        bool valid = kpos < t;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && qpos - kpos < window;
        sc[i][j] = valid ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = mrow[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            sc[i][j] <= kNegInf / 2 ? 0.f : expf(sc[i][j] - m_new);
        Pt[(tx + 8 * j) * kBQ + r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();  // every lane has read mrow[r] before lane tx 0 writes
      if (tx == 0) {
        const float corr = expf(m_prev - m_new);
        crow[r] = corr;
        lrow[r] = lrow[r] * corr + sum;
        mrow[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float corr = crow[r0 + i];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) p[i] = Pt[j * kBQ + r0 + i];
      const float4 v0 = *reinterpret_cast<const float4*>(Vs + j * D + cx * 4);
      const float4 v1 =
          *reinterpret_cast<const float4*>(Vs + j * D + D / 2 + cx * 4);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        acc[i][0] = fmaf(p[i], v0.x, acc[i][0]);
        acc[i][1] = fmaf(p[i], v0.y, acc[i][1]);
        acc[i][2] = fmaf(p[i], v0.z, acc[i][2]);
        acc[i][3] = fmaf(p[i], v0.w, acc[i][3]);
        acc[i][4] = fmaf(p[i], v1.x, acc[i][4]);
        acc[i][5] = fmaf(p[i], v1.y, acc[i][5]);
        acc[i][6] = fmaf(p[i], v1.z, acc[i][6]);
        acc[i][7] = fmaf(p[i], v1.w, acc[i][7]);
      }
    }
  }
  __syncthreads();  // l of the last tile (or of none) is written

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int gr = q0 + r0 + i;
    if (gr >= s) continue;
    const float den = fmaxf(lrow[r0 + i], 1e-30f);
    T* orow = out + (static_cast<size_t>(head) * s + gr) * d;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = (c < 4 ? cx * 4 : D / 2 + cx * 4) + (c & 3);
      if (col < d) orow[col] = from_f<T>(acc[i][c] / den);
    }
  }
}

template <int D, typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int bh,
             int s, int t, int d, int group, int causal, int window,
             float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  // once per instantiation, at the first (eager) call: later calls may be
  // captured into a CUDA graph, where the attribute call does not belong
  static bool smem_set = false;
  if (smem > 48 * 1024 && !smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid((s + kBQ - 1) / kBQ, bh);
  flash_kernel<D, T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, t, d, group, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int s, int t, int d, int group, int causal, int window,
           float scale, cudaStream_t st) {
  if (d <= 64)
    return launch_d<64, T>(q, k, v, out, bh, s, t, d, group, causal, window,
                           scale, st);
  if (d <= 128)
    return launch_d<128, T>(q, k, v, out, bh, s, t, d, group, causal,
                            window, scale, st);
  if (d <= 256)
    return launch_d<256, T>(q, k, v, out, bh, s, t, d, group, causal,
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
