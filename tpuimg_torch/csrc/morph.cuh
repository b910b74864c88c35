// Shared pieces of the morphology kernels (morphology.cu, open_close.cu):
// the dtype codes, the extreme of two values, the clamped staging of a
// tile's extent (morphology.cu) and the launch over a batch of frames.
#pragma once

#include "common.cuh"

namespace morph {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kMaxGridZ = 65535;

// dtype codes of the C entry points (kernels/sep_stencil.py MORPH_DTYPES)
enum Dtype { kU8 = 0, kI32 = 1, kF32 = 2 };

// min (kMin) or max of a and b. NaN propagates: `a != a` keeps a NaN a, and
// a NaN b fails the compare and is returned, as torch.minimum/maximum and
// tpuimg's jnp.minimum/maximum do (fminf/fmaxf would drop it). Equal values
// (+0 and -0) return a; results are held as values.
template <bool kMin, class T>
__device__ __forceinline__ T extreme(T a, T b) {
  const bool keep_a = kMin ? a < b : b < a;
  return (keep_a || a != a) ? a : b;
}

__host__ __device__ inline int clamp_index(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// dst (eh x ew) = the plane src (row stride w, h rows) at rows
// clamp(ys .. ys + eh) and columns clamp(xs .. xs + ew): the replicate
// border. One warp per row, its lanes along the row. Every thread of the
// block takes part; the caller synchronises.
template <class T>
__device__ __forceinline__ void stage_clamped(const T* __restrict__ src,
                                              int h, int w, int ys, int eh,
                                              int xs, int ew, T* dst) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int ey = threadIdx.x >> 5; ey < eh; ey += nwarps) {
    const T* row = src + static_cast<size_t>(clamp_index(ys + ey, h)) * w;
    for (int ex = lane; ex < ew; ex += 32) {
      dst[ey * ew + ex] = row[clamp_index(xs + ex, w)];
    }
  }
}

inline dim3 tile_grid(int n, int h, int w, int tile) {
  return dim3((w + tile - 1) / tile, (h + tile - 1) / tile,
              n < kMaxGridZ ? n : kMaxGridZ);
}

// Raise the kernel's dynamic shared memory limit to `bytes`, then launch
// it on the grid of tile x tile outputs; returns the CUDA error code.
template <class K, class... Args>
int launch_tiles(K kernel, size_t bytes, int n, int h, int w, int tile,
                 cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the caller gets the code
    return static_cast<int>(err);
  }
  kernel<<<tile_grid(n, h, w, tile), kThreads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace morph
