// Shared device helpers for the tpuimg_torch kernels.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// reflect-101 (mirror without repeating the edge): valid for -n < x < 2n - 1,
// the map of the reference's reflectBorder / dLimitSize. Kernels whose
// frames are gated far above their halo use it (tile_hist, enhance_tail).
__device__ __forceinline__ int reflect101(int x, int n) {
  x = abs(x);
  const int over = x - (n - 1);
  return over > 0 ? x - 2 * over : x;
}

// reflect-101 for every x, mirrored again past each edge: periodic with
// period 2(n - 1), and 0 for n = 1. This is np.pad(mode="reflect")'s map,
// and tpuimg_torch/core/borders.py::reflect101_index; it makes a kernel
// exact on frames smaller than its halo.
__device__ __forceinline__ int reflect101_any(int x, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  const int m = abs(x) % period;
  return m >= n ? period - m : m;
}

// idx[i] = reflect101_any(start + i, n) for i < len: a block's reflected
// rows or columns, computed once so that staging needs no division.
// Every thread of the block takes part; the caller synchronises.
__device__ __forceinline__ void reflect101_table(int start, int len, int n,
                                                 int* idx) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    idx[i] = reflect101_any(start + i, n);
  }
}

// dst (eh x ew) = the plane src (row stride w) at rows ys[0 .. eh) and
// columns xs[0 .. ew): one warp per row, its lanes along the row. Every
// thread of the block takes part; the caller synchronises.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int w, const int* ys, int eh,
                                           const int* xs, int ew,
                                           float* dst) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int ey = threadIdx.x >> 5; ey < eh; ey += nwarps) {
    const float* row = src + static_cast<size_t>(ys[ey]) * w;
    for (int ex = lane; ex < ew; ex += 32) dst[ey * ew + ex] = row[xs[ex]];
  }
}
