// Shared pieces of the morphology kernels (morphology.cu, open_close.cu):
// the dtype codes, the extreme of two values, each pass's identity, the van
// Herk/Gil-Werman window pass over lines in shared memory (u8 four to a word
// down the columns), the odd row strides, and the launch over a batch of
// frames.
#pragma once

#include "common.cuh"

namespace morph {

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

// the unit of a pass down the columns: four u8 pixels packed in a word
template <class T>
struct ColUnit {
  using U = T;
  static constexpr int kPer = 1;
};
template <>
struct ColUnit<uint8_t> {
  using U = uint32_t;
  static constexpr int kPer = 4;
};

template <bool kMin, class U>
__device__ __forceinline__ U ext(U a, U b) {
  return extreme<kMin>(a, b);
}
template <>
__device__ __forceinline__ uint32_t ext<true, uint32_t>(uint32_t a,
                                                        uint32_t b) {
  return __vminu4(a, b);
}
template <>
__device__ __forceinline__ uint32_t ext<false, uint32_t>(uint32_t a,
                                                         uint32_t b) {
  return __vmaxu4(a, b);
}

// the value a min (kMin) or max leaves unchanged
template <bool kMin, class U>
__device__ __forceinline__ U identity();
template <>
__device__ __forceinline__ float identity<true, float>() {
  return __int_as_float(0x7f800000);  // +inf
}
template <>
__device__ __forceinline__ float identity<false, float>() {
  return __int_as_float(0xff800000);  // -inf
}
template <>
__device__ __forceinline__ int32_t identity<true, int32_t>() {
  return INT32_MAX;
}
template <>
__device__ __forceinline__ int32_t identity<false, int32_t>() {
  return INT32_MIN;
}
template <>
__device__ __forceinline__ uint8_t identity<true, uint8_t>() { return 255; }
template <>
__device__ __forceinline__ uint8_t identity<false, uint8_t>() { return 0; }
template <>
__device__ __forceinline__ uint32_t identity<true, uint32_t>() {
  return 0xffffffffu;
}
template <>
__device__ __forceinline__ uint32_t identity<false, uint32_t>() {
  return 0u;
}

// words of a row of n elements of `size` bytes, made odd
__host__ __device__ inline int row_words(int n, int size) {
  return ((n * size + 3) / 4) | 1;
}

// out[line][j] = the extreme of in[line][j .. j + k - 1] for j < lout, over
// `lines` lines; a line's elements are `es` apart, lines `ls` apart (in units
// of U). Van Herk/Gil-Werman: a thread takes the k outputs of one block,
// writes the suffix extremes of its k inputs, then folds in the prefix
// extremes of the next block's. Items go line-fastest, so neighbouring
// threads work on neighbouring lines.
template <bool kMin, class U>
__device__ __forceinline__ void window_pass(const U* in, int ls, int es,
                                            U* out, int ols, int oes,
                                            int lines, int lout, int k) {
  const int nb = (lout + k - 1) / k;
  // (line, blk) of item tid, and the step of kThreads items, divided once
  const int dq = kThreads / lines, dr = kThreads - dq * lines;
  int line = threadIdx.x % lines, blk = threadIdx.x / lines;
  const U id = identity<kMin, U>();
  while (blk < nb) {
    const int j0 = blk * k;
    const int n = min(k, lout - j0);
    const U* src = in + line * ls;
    U* dst = out + line * ols;
    U h = id;
    for (int p = j0 + k - 1; p >= j0 + n; --p) h = ext<kMin>(src[p * es], h);
#pragma unroll 4
    for (int p = j0 + n - 1; p >= j0; --p) {
      h = ext<kMin>(src[p * es], h);
      dst[p * oes] = h;
    }
    U g = id;
#pragma unroll 4
    for (int t = 1; t < n; ++t) {
      g = ext<kMin>(g, src[(j0 + k - 1 + t) * es]);
      dst[(j0 + t) * oes] = ext<kMin>(dst[(j0 + t) * oes], g);
    }
    line += dr;
    blk += dq;
    if (line >= lines) {
      line -= lines;
      ++blk;
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
