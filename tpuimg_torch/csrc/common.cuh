// Shared device helpers for the tpuimg_torch kernels.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// reflect-101 (mirror without repeating the edge): valid for -n < x < 2n - 1,
// the map of tpuimg/core/borders.py::reflect101_index and the reference's
// reflectBorder / dLimitSize.
__device__ __forceinline__ int reflect101(int x, int n) {
  x = abs(x);
  const int over = x - (n - 1);
  return over > 0 ? x - 2 * over : x;
}
