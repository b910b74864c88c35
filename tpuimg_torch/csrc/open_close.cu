// Fused morphological open (erode then dilate) and close (dilate then
// erode), square structuring element of side 2r+1, replicate border, of a
// batch of u8, int32 or float32 frames, in one launch.
//
// Replaces tpuimg/kernels/sep_stencil.py::open_close_pallas (:509;
// _open_close :478, kernel _open_close_kernel :436). The stage-1 result
// never reaches device memory. The composed op's replicate border acts on
// the stage-1 result (sep_stencil.py:441-445), so stage 2 reads stage 1
// only at in-frame positions, clamped: a fresh extreme over replicated raw
// pixels would differ at the border.
//
// Design on this card: one block per 32x32 output tile of one frame
// (gridDim.z over the frames) stages its (32 + 4r)^2 input extent, clamped
// (the replicate border of stage 1; see morphology.cu), then
//   1. stage 1 along the rows, at the (32 + 2r) clamped columns
//      cx = clamp(x0 - r + i) that stage 2 reads;
//   2. stage 1 down the columns, at the clamped rows cy = clamp(y0 - r + j):
//      the (32 + 2r)^2 stage-1 values stage 2 needs, border clamp included;
//   3. stage 2 along the rows and 4. down the columns, into the tile.
// Each pass is a direct (2r+1)-tap loop in shared memory, unrolled by 8
// (at nvcc's default the u8 instances spill 64 bytes); stage 1's
// result and stage 2's row pass reuse the input's and stage 1's row
// buffers. Shared memory is ((32 + 4r)^2 + (32 + 4r)(32 + 2r)) elements:
// 224,096 bytes for 4-byte elements at r = 39, the largest under the
// 227 KB a block may use (kOpenCloseMaxRadius); above it the wrapper
// composes two morphology.cu launches, as tpuimg composes two kernels for
// frames wider than its lane limit (sep_stencil.py:518-520).
// Bound: shared-memory loads, (2r + 1) for each of the four passes' outputs
// over the tile: about 380 per output pixel at r = 15, four times a single
// erode's 91, against one element read and one written per pixel of device
// memory (half the composed form's traffic).
#include "morph.cuh"

constexpr int kOpenCloseMaxRadius = 39;

namespace {

using morph::clamp_index;
using morph::extreme;
using morph::kThreads;
using morph::kTile;

template <class T, bool kMinFirst>
__global__ void __launch_bounds__(kThreads)
open_close_kernel(const T* __restrict__ src, int n, int h, int w, int r,
                  T* __restrict__ dst) {
  constexpr bool kMinSecond = !kMinFirst;
  extern __shared__ __align__(16) unsigned char smem[];
  const int e1 = kTile + 4 * r, e2 = kTile + 2 * r;
  T* E = reinterpret_cast<T*>(smem);  // e1 x e1 input; then S1, e2 x e2
  T* R = E + e1 * e1;                 // e1 x e2 stage-1 rows; then e2 x kTile
  T* S1 = E;
  T* R2 = R;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const size_t plane = static_cast<size_t>(h) * w;

  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    morph::stage_clamped(src + z * plane, h, w, y0 - 2 * r, e1, x0 - 2 * r,
                         e1, E);
    __syncthreads();

    // 1. stage 1 along the rows: R[row][i] over E[row][c .. c + 2r], c the
    //    extent column of clamp(x0 - r + i) - r
    for (int idx = tid; idx < e1 * e2; idx += kThreads) {
      const int row = idx / e2, i = idx - row * e2;
      const T* c = E + row * e1 + clamp_index(x0 - r + i, w) - x0 + r;
      T acc = c[0];
#pragma unroll 8
      for (int k = 1; k <= 2 * r; ++k) acc = extreme<kMinFirst>(acc, c[k]);
      R[idx] = acc;
    }
    __syncthreads();

    // 2. stage 1 down the columns: S1[j][i] over the extent rows of
    //    clamp(y0 - r + j) - r .. + r
    for (int idx = tid; idx < e2 * e2; idx += kThreads) {
      const int j = idx / e2, i = idx - j * e2;
      const T* c = R + (clamp_index(y0 - r + j, h) - y0 + r) * e2 + i;
      T acc = c[0];
#pragma unroll 8
      for (int k = 1; k <= 2 * r; ++k) {
        acc = extreme<kMinFirst>(acc, c[k * e2]);
      }
      S1[idx] = acc;
    }
    __syncthreads();

    // 3. stage 2 along the rows: R2[j][col] over S1[j][col .. col + 2r]
    for (int idx = tid; idx < e2 * kTile; idx += kThreads) {
      const int j = idx / kTile, col = idx - j * kTile;
      const T* c = S1 + j * e2 + col;
      T acc = c[0];
#pragma unroll 8
      for (int k = 1; k <= 2 * r; ++k) acc = extreme<kMinSecond>(acc, c[k]);
      R2[idx] = acc;
    }
    __syncthreads();

    // 4. stage 2 down the columns: out[row][col] over R2[row .. row + 2r]
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      const int row = idx / kTile, col = idx - row * kTile;
      const int y = y0 + row, x = x0 + col;
      if (y >= h || x >= w) continue;
      const T* c = R2 + row * kTile + col;
      T acc = c[0];
#pragma unroll 8
      for (int k = 1; k <= 2 * r; ++k) {
        acc = extreme<kMinSecond>(acc, c[k * kTile]);
      }
      dst[z * plane + static_cast<size_t>(y) * w + x] = acc;
    }
    __syncthreads();  // E and R are refilled for the next frame
  }
}

template <class T>
int open_close(const void* src, int n, int h, int w, int r, int mode,
               void* dst, cudaStream_t stream) {
  const int e1 = kTile + 4 * r, e2 = kTile + 2 * r;
  const size_t bytes = static_cast<size_t>(e1 * e1 + e1 * e2) * sizeof(T);
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  return mode == 0 ? morph::launch_tiles(open_close_kernel<T, true>, bytes, n,
                                         h, w, stream, s, n, h, w, r, d)
                   : morph::launch_tiles(open_close_kernel<T, false>, bytes, n,
                                         h, w, stream, s, n, h, w, r, d);
}

}  // namespace

// src, dst: n frames of (h, w), contiguous, of dtype code `dtype`
// (morph::Dtype); mode 0 opens (erode first), 1 closes (dilate first);
// 0 <= r <= kOpenCloseMaxRadius.
extern "C" int tpuimg_open_close(const void* src, int n, int h, int w,
                                 int dtype, int r, int mode, void* dst,
                                 cudaStream_t stream) {
  if (n < 1 || h < 1 || w < 1 || r < 0 || r > kOpenCloseMaxRadius ||
      (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case morph::kU8:
      return open_close<uint8_t>(src, n, h, w, r, mode, dst, stream);
    case morph::kI32:
      return open_close<int32_t>(src, n, h, w, r, mode, dst, stream);
    case morph::kF32:
      return open_close<float>(src, n, h, w, r, mode, dst, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
