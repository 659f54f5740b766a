// Element loaders shared by the kernels of bgmv.cu and lora_matmul.cu.
//
// A W loader returns W[row, col] of a logical (k, n) weight as fp32, from
//   DenseW  a row-major fp32 or bf16 matrix;
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
// the order of their sums.  A packed loader also splits the element in two,
// fetch (the loads: the raw byte and its scale) and cvt (the integer and
// fp32 arithmetic on them), so that a tile can keep a slab's loads in
// flight while it computes on the one before.  A loader reads only what it
// is asked for: callers mask rows >= k and cols >= n.  The weights are
// read-only for a kernel's lifetime, so loads go through the read-only data
// cache (__ldg).
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

template <typename T>
struct DenseW {
  const T* w;
  int n;
  __device__ __forceinline__ float operator()(int row, int col) const {
    return to_f(__ldg(w + static_cast<size_t>(row) * n + col));
  }
};

// The dequantized element: the fp32 product, or (kBf16) that product
// rounded to the nearest bf16, ties to even, as Tensor.to(torch.bfloat16).
template <bool kBf16>
__device__ __forceinline__ float dequant(float q, float scale) {
  const float v = q * scale;
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
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
  __device__ __forceinline__ float operator()(int row, int col) const {
    return cvt(fetch(row, col));
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
  // The same element in one step, for the GEMV body (gemv.cuh).  Not
  // cvt(fetch()): with it the GEMV took 26.7 / 132.5 us at int4 q / w_up,
  // m = 4, against 18.5 / 122 this way, while cvt with this select instead
  // of the shift slowed the tiles 5-11% (on an H100; PERF.md).
  __device__ __forceinline__ float operator()(int row, int col) const {
    const int byte = __ldg(d + static_cast<size_t>(row >> 1) * n + col);
    int v = (row & 1) ? (byte >> 4) : (byte & 0xF);
    v -= 2 * (v & 8);  // sign-extend the nibble
    return dequant<kBf16>(
        static_cast<float>(v),
        __ldg(s + static_cast<size_t>(row >> group_shift) * n + col));
  }
};

// log2 of a power-of-two group size (host side, when building an Int4W).
inline int log2_group(int group) {
  int shift = 0;
  while ((1 << shift) < group) ++shift;
  return shift;
}

// Host side: build the loader for a packed W (wd, ws, n columns; bits 8 or
// 4, the int4 group size, bf16w = round to bf16) and return f(loader), or
// cudaErrorInvalidValue for any other bits.  Every entry point over a
// packed W goes through here, so each kernel is instantiated for all four.
template <typename F>
int with_packed_w(const void* wd, const float* ws, int n, int bits, int group,
                  int bf16w, F&& f) {
  if (bits == 8) {
    const int8_t* d = static_cast<const int8_t*>(wd);
    return bf16w ? f(Int8W<true>{d, ws, n}) : f(Int8W<false>{d, ws, n});
  }
  if (bits == 4) {
    const uint8_t* d = static_cast<const uint8_t*>(wd);
    const int shift = log2_group(group);
    return bf16w ? f(Int4W<true>{d, ws, n, shift})
                 : f(Int4W<false>{d, ws, n, shift});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_kernels
