// Shared device helpers for the tpuimg_torch kernels.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// the shared memory a block may use on an H100 (227 KB)
constexpr int kMaxSmemBytes = 232448;

// 4 bytes from device memory into shared memory, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// 16 bytes, cached in L2 only (the source may be this block's own stores)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// one shared-memory atomic into hist for each of the four bytes of word
__device__ __forceinline__ void count_word(unsigned word, int* hist) {
  atomicAdd(&hist[word & 0xFFu], 1);
  atomicAdd(&hist[(word >> 8) & 0xFFu], 1);
  atomicAdd(&hist[(word >> 16) & 0xFFu], 1);
  atomicAdd(&hist[word >> 24], 1);
}

// byte j (0-15, known at compile time once unrolled) of the 16 in v
__device__ __forceinline__ unsigned byte_of(const uint4& v, int j) {
  const unsigned w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 0xFFu;
}

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

// reflect101_any without its modulo wherever one mirror reaches (|x| <=
// 2(n - 1)): only a frame narrower than the halo takes the modulo.
__device__ __forceinline__ int reflect101_fast(int x, int n) {
  x = abs(x);
  if (x < n) return x;
  const int y = 2 * (n - 1) - x;
  return y >= 0 ? y : reflect101_any(x, n);
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

// idx[i] = min(start + i, n - 1) for i < len: a tile's rows of a block whose
// row halo is already in device memory (the ypadded kernels: a shard's block
// with its neighbours' rows). Rows past the block's end only feed outputs
// past its last output row, which are not written. Every thread of the block
// takes part; the caller synchronises.
__device__ __forceinline__ void clamped_table(int start, int len, int n,
                                              int* idx) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    idx[i] = min(start + i, n - 1);
  }
}

// The CLAHE tile grid of a frame: (ytiles*xtiles, 256) float tables, the
// tile height, the centred padding and the host's f32 reciprocal of the tile
// width.
struct ClaheGeom {
  const float* tables;
  int ytiles, xtiles;
  float th, pad_top, pad_left, inv_tw;
};

// One coordinate of the CLAHE blend: the tile pair (t1, t2) around it and
// its weights (a toward t2, a1 = 1 - a). Rows and columns take the same
// steps but for the row's IEEE division by th where the column multiplies
// by the host's f32 1/tw.
struct ClaheAxis {
  int t1, t2;
  float a, a1;
};

// f = tile coordinate + 0.5, as the reference computes it; t1 truncates
// toward zero (a may be negative at the first border), t2 clamps to the
// last tile
__device__ __forceinline__ ClaheAxis clahe_axis(float f, int tiles) {
  const float tf = __fsub_rn(f, 0.5f);
  ClaheAxis ax;
  ax.t1 = __float2int_rz(tf);
  ax.t2 = min(ax.t1 + 1, tiles - 1);
  ax.a = __fsub_rn(tf, static_cast<float>(ax.t1));
  ax.a1 = __fsub_rn(1.0f, ax.a);
  return ax;
}

__device__ __forceinline__ ClaheAxis clahe_row(const ClaheGeom& g, int y) {
  return clahe_axis(__fdiv_rn(__fadd_rn(static_cast<float>(y), g.pad_top),
                              g.th), g.ytiles);
}

__device__ __forceinline__ ClaheAxis clahe_col(const ClaheGeom& g, int x) {
  return clahe_axis(__fmul_rn(__fadd_rn(static_cast<float>(x), g.pad_left),
                              g.inv_tw), g.xtiles);
}

// (t11*xa1 + t12*xa)*ya1 + (t21*xa1 + t22*xa)*ya, every multiply and add
// rounded on its own (__fmul_rn/__fadd_rn), so that nvcc cannot contract it
// into FMAs
__device__ __forceinline__ float clahe_lerp(float t11, float t12, float t21,
                                            float t22, float xa, float xa1,
                                            float ya, float ya1) {
  const float top = __fadd_rn(__fmul_rn(t11, xa1), __fmul_rn(t12, xa));
  const float bot = __fadd_rn(__fmul_rn(t21, xa1), __fmul_rn(t22, xa));
  return __fadd_rn(__fmul_rn(top, ya1), __fmul_rn(bot, ya));
}

// The CLAHE bilinear 4-LUT blend of pixel value v at (y, x), in [0, 255].
// Coordinate math is the reference's (gInterpolateMappingUnroll) and
// tpuimg's, bit for bit: tyf = __fdiv_rn(y + pad_top, th) - 0.5 and
// txf = (x + pad_left) * inv_tw - 0.5 (clahe_row, clahe_col), then
// clahe_lerp of the four corner tables' entries, so every kernel that calls
// this computes the plain PyTorch version's value exactly.
__device__ __forceinline__ float clahe_blend(const ClaheGeom& g, int v, int y,
                                             int x) {
  const ClaheAxis ry = clahe_row(g, y), cx = clahe_col(g, x);
  const float t11 = __ldg(&g.tables[(ry.t1 * g.xtiles + cx.t1) * 256 + v]);
  const float t12 = __ldg(&g.tables[(ry.t1 * g.xtiles + cx.t2) * 256 + v]);
  const float t21 = __ldg(&g.tables[(ry.t2 * g.xtiles + cx.t1) * 256 + v]);
  const float t22 = __ldg(&g.tables[(ry.t2 * g.xtiles + cx.t2) * 256 + v]);
  return clahe_lerp(t11, t12, t21, t22, cx.a, cx.a1, ry.a, ry.a1);
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
