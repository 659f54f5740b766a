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
// forms, so a kernel over a packed W and its plain version (x @
// dequantize(W)) differ only in the order of their sums.  A loader reads
// only what it is asked for: callers mask rows >= k and cols >= n.  The
// weights are read-only for a kernel's lifetime, so loads go through the
// read-only data cache (__ldg).
#pragma once

#include <cuda_bf16.h>

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

struct Int8W {
  const int8_t* d;
  const float* s;
  int n;
  __device__ __forceinline__ float operator()(int row, int col) const {
    return static_cast<float>(__ldg(d + static_cast<size_t>(row) * n + col)) *
           __ldg(s + col);
  }
};

struct Int4W {
  const uint8_t* d;
  const float* s;
  int n;
  int group_shift;  // log2 of the group size
  __device__ __forceinline__ float operator()(int row, int col) const {
    const int byte = __ldg(d + static_cast<size_t>(row >> 1) * n + col);
    int v = (row & 1) ? (byte >> 4) : (byte & 0xF);
    v -= 2 * (v & 8);  // sign-extend the nibble
    return static_cast<float>(v) *
           __ldg(s + static_cast<size_t>(row >> group_shift) * n + col);
  }
};

// log2 of a power-of-two group size (host side, when building an Int4W).
inline int log2_group(int group) {
  int shift = 0;
  while ((1 << shift) < group) ++shift;
  return shift;
}

}  // namespace repro_kernels
