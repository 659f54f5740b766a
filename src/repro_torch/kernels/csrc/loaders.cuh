// Element loaders, decode and copy helpers shared by the kernels of
// bgmv.cu, lora_matmul.cu, packed_dx.cu, qgemv.cu, flash_attention.cu and
// lora_grads.cu.
//
// A packed W loader reads W[row, col] of a logical (k, n) weight from
//   Int8W   int8 data (k, n) and per-channel fp32 scales (1, n);
//   Int4W   uint8 data (kq / 2, n), two rows per byte (row 2i in the low
//           nibble, row 2i + 1 in the high nibble, 4-bit two's complement),
//           and fp32 group scales (kq / group, n); the group size is a power
//           of two, so the loader shifts by its log2 (log2_group) instead of
//           dividing;
// the byte layout of src/repro_torch/core/quant.py.  The packed loaders
// form the one fp32 product float(q) * scale that core/quant.dequantize
// forms, and with kBf16 (a base packed from bf16 weights) round it to bf16
// and back, as dequantize's cast to the weights' dtype does; so a kernel
// over a packed W and its plain version (x @ dequantize(W)) differ only in
// the order of their sums.  A loader splits the element in two, fetch (the
// loads: the raw byte and its scale) and cvt (the integer and fp32
// arithmetic on them), so that a tile can keep a slab's loads in flight
// while it computes on the one before (fwd_tile.cuh's stagers).  A loader
// reads only what it is asked for: callers mask rows >= k and cols >= n.
// The weights are read-only for a kernel's lifetime, so loads go through
// the read-only data cache (__ldg).  The decode GEMV (qgemv.cu) reads
// packed rows a word at a time instead (s8_float / s4_float below).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace repro_kernels {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The dequantized element: the fp32 product, or (kBf16) that product
// rounded to the nearest bf16, ties to even, as Tensor.to(torch.bfloat16).
template <bool kBf16>
__device__ __forceinline__ float dequant(float q, float scale) {
  const float v = q * scale;
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// One element of an fp32 or bf16 operand through the read-only data cache.
// A bf16 element is loaded as its 16 bits by the integer __ldg: the
// bf16 overload of __ldg in cuda_bf16.h is an inline asm, which the
// compiler may run ahead of the bounds check that guards it, at the
// unmasked address (on an H100, #10's scalar path read past the end of a
// bf16 operand that way, and faulted where the next page was unmapped).
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ldg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p)));
}

template <bool kBf16>
struct Int8W {
  struct Raw {
    int8_t q;
    float s;
  };
  const int8_t* d;
  const float* s;
  int n;
  __device__ __forceinline__ Raw fetch(int row, int col) const {
    return {__ldg(d + static_cast<size_t>(row) * n + col), __ldg(s + col)};
  }
  static __device__ __forceinline__ float cvt(Raw e) {
    return dequant<kBf16>(static_cast<float>(e.q), e.s);
  }
};

template <bool kBf16>
struct Int4W {
  const uint8_t* d;
  const float* s;
  int n;
  int group_shift;  // log2 of the group size
  struct Raw {
    int byte;
    int shift;  // 4 for an odd row (the high nibble), else 0
    float s;
  };
  __device__ __forceinline__ Raw fetch(int row, int col) const {
    return {__ldg(d + static_cast<size_t>(row >> 1) * n + col),
            (row & 1) * 4,
            __ldg(s + static_cast<size_t>(row >> group_shift) * n + col)};
  }
  static __device__ __forceinline__ float cvt(Raw e) {
    int v = (e.byte >> e.shift) & 0xF;
    v -= 2 * (v & 8);  // sign-extend the nibble
    return dequant<kBf16>(static_cast<float>(v), e.s);
  }
};

// 4 consecutive elements in one load (fwd_tile.cuh's stagers,
// flash_attention.cu; lora_grads.cu from shared memory): float4, or 4 bf16
// in a uint2; as_f4 widens them to fp32, ld4 loads them (zeros where !in).
template <typename E>
struct Vec4 {
  using U = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using U = uint2;
};
__device__ __forceinline__ float4 as_f4(float4 u) { return u; }
__device__ __forceinline__ float4 as_f4(uint2 u) {
  // a bf16 is the top half of the fp32 with the same value
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
template <typename E>
__device__ __forceinline__ typename Vec4<E>::U ld4(const E* p, bool in) {
  using U = typename Vec4<E>::U;
  return in ? __ldg(reinterpret_cast<const U*>(p)) : U{};
}

// Word-wide decode, for the kernels that load a packed W 4 bytes (or more)
// at a time (fwd_tile.cuh's stagers, qgemv.cuh): the integers become floats
// without a conversion instruction.  A byte (or nibble) with its sign bit
// flipped is the low mantissa bits of 2^23 + 128 + q (2^23 + 8 + q), one
// byte permute and one exact subtraction away from float(q).

// float(q) of signed byte u of w ^ 0x80808080
__device__ __forceinline__ float s8_float(unsigned wx, int u) {
  // bytes: [byte u of wx, 0, 0, 0x4B] = 2^23 + (q + 128)
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, u | 0x7650)) -
         8388736.f;
}

// float(q) of signed nibble u (nibbles of w ^ 0x88888888 split into
// bytes: lo holds the even nibbles, hi the odd ones)
__device__ __forceinline__ float s4_float(unsigned nib, int u) {
  return __uint_as_float(__byte_perm(nib, 0x4B000000u, u | 0x7650)) -
         8388616.f;
}

// dst (shared) <- kBytes (16, 8 or 4) of src (global), asynchronously;
// zeros where !in.  16-byte copies bypass L1 (.cg), smaller ones cannot.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool in = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(in ? kBytes : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Host side: whether p is a multiple of bytes (the vector paths' loads).
inline bool is_aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// log2 of a power-of-two group size (host side, when building an Int4W).
inline int log2_group(int group) {
  int shift = 0;
  while ((1 << shift) < group) ++shift;
  return shift;
}

}  // namespace repro_kernels
