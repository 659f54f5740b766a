// The split-k GEMV body shared by bgmv.cu (#1 and #4, with the rank-r
// term added by their finalize) and lora_matmul.cu (#11's decode form).
//
// Decode shapes are bound by reading W.  A block owns 32 columns (lane =
// column, so each warp reads 32 contiguous elements of a W row) and a
// k-slice of kchunk rows split over its 8 warps, and accumulates up to
// kGvMaxB = 8 rows of x per W element: W is read once per call for up to 8
// rows (gridDim.z takes each further 8), where the TPU grid re-reads it per
// request.  Splitting k over gridDim.y puts enough blocks in flight to fill
// the card's memory pipeline; the ksplit partial sums go to scratch
// (partial[ks][row][col]) for a second kernel to add in a fixed order.
// W comes through a loader (loaders.cuh): fp, or dequantized as it is
// loaded.
#pragma once

#include "loaders.cuh"

namespace repro_kernels {

constexpr int kGvCols = 32, kGvWarps = 8, kGvMaxB = 8;

// internal linkage: each translation unit that includes this header
// instantiates and registers its own copy of the kernel
namespace {

template <typename T, typename WL>
__global__ void __launch_bounds__(kGvCols * kGvWarps)
gemv_partial_kernel(const T* __restrict__ x, const WL wl,
                    float* __restrict__ partial, int nb, int k, int n,
                    int kchunk) {
  __shared__ float red[kGvWarps][kGvMaxB][kGvCols];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int col = blockIdx.x * kGvCols + lane;
  const int b0 = blockIdx.z * kGvMaxB;
  const int nbb = min(kGvMaxB, nb - b0);
  const int k0 = blockIdx.y * kchunk;
  const int k1 = min(k, k0 + kchunk);
  float acc[kGvMaxB];
#pragma unroll
  for (int b = 0; b < kGvMaxB; ++b) acc[b] = 0.f;
  if (col < n) {
#pragma unroll 4
    for (int kk = k0 + warp; kk < k1; kk += kGvWarps) {
      const float wv = wl(kk, col);
#pragma unroll
      for (int b = 0; b < kGvMaxB; ++b)
        if (b < nbb)
          acc[b] = fmaf(to_f(x[static_cast<size_t>(b0 + b) * k + kk]), wv,
                        acc[b]);
    }
  }
#pragma unroll
  for (int b = 0; b < kGvMaxB; ++b) red[warp][b][lane] = acc[b];
  __syncthreads();
  if (warp == 0 && col < n) {
    for (int b = 0; b < nbb; ++b) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kGvWarps; ++q) sum += red[q][b][lane];
      partial[(static_cast<size_t>(blockIdx.y) * nb + b0 + b) * n + col] = sum;
    }
  }
}

}  // namespace
}  // namespace repro_kernels
