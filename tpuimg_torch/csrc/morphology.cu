// Grayscale erode (min) and dilate (max) over a (2r+1)^2 square structuring
// element, replicate border, of a batch of u8, int32 or float32 frames.
//
// Replaces tpuimg/kernels/sep_stencil.py::morphology_pallas (:575; band
// kernel _make_kernel :206 in _sep_stencil :272, with the doubling-window
// extremes of tpuimg/kernels/window.py:39). The TPU widens u8 to bf16 for
// its (8, 128) tiles and streams row bands with halo views; here every
// dtype is computed natively (min and max are exact in any type) and the
// border is a clamped index, because for min and max the replicate border
// is the clamped window:
//   out[y, x] = ext over rows [max(0, y-r), min(h-1, y+r)]
//                      x cols [max(0, x-r), min(w-1, x+r)],
// every replicated pixel being inside that window already. The caller
// passes r = min(radius, max(h, w) - 1), which gives the same result.
//
// Two routes, chosen by r in the one C call:
// - r <= kMorphMaxTileRadius: one launch, one block per 32x32 output tile
//   of one frame (gridDim.z over the frames). The tile's (32 + 2r)^2
//   clamped extent is staged in shared memory, then a pass along the rows
//   and one down the columns, each a direct (2r+1)-tap loop. Shared memory
//   is ((32 + 2r)^2 + 32(32 + 2r)) elements: 229,376 bytes for 4-byte
//   elements at r = 96, the largest under the 227 KB a block may use.
// - larger r: a row pass into `scratch` and a column pass out of it, two
//   launches of one thread per pixel reading its clamped window from device
//   memory (L1/L2 hits), so every radius is exact.
// Bound: shared-memory loads, about (2r + 1)(2 + 2r/32) per output pixel,
// against 2 element reads and writes of device memory per pixel (plus the
// halo re-read, which hits L2).
//
// A second entry, tpuimg_morphology_ypadded, replaces
// tpuimg/kernels/sep_stencil.py::morph_pallas_ypadded (:594, pallas_call
// :417 in _sep_stencil_ypadded :371): a shard's block whose rows already
// carry r halo rows on each side, (h + 2r, w) in and (h, w) out. Output row
// y takes the extreme over block rows y .. y + 2r (no border in y) and the
// clamped columns, so both routes run with a row offset `yoff` = r into a
// source of h + 2*yoff rows: the tile route stages rows from y0 on, the
// column pass reads rows [y, y + 2r]. The radius is the block's own; it is
// never shrunk to the frame (the block's height is fixed at h + 2r).
#include <algorithm>

#include "morph.cuh"

constexpr int kMorphMaxTileRadius = 96;

namespace {

using morph::extreme;
using morph::kThreads;
using morph::kTile;

template <class T, bool kMin>
__global__ void __launch_bounds__(kThreads)
morph_tile_kernel(const T* __restrict__ src, int n, int h, int w, int r,
                  int yoff, T* __restrict__ dst) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = kTile + 2 * r;
  T* E = reinterpret_cast<T*>(smem);  // e x e: clamped input extent
  T* R = E + e * e;                   // e x kTile: row pass
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int hin = h + 2 * yoff;  // rows of a source frame
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t in_plane = static_cast<size_t>(hin) * w;

  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    morph::stage_clamped(src + z * in_plane, hin, w, y0 + yoff - r, e, x0 - r,
                         e, E);
    __syncthreads();

    // 1. along the rows: R[row][col] over E[row][col .. col + 2r]
    for (int i = tid; i < e * kTile; i += kThreads) {
      const int row = i / kTile, col = i - row * kTile;
      const T* c = E + row * e + col;
      T acc = c[0];
      for (int k = 1; k <= 2 * r; ++k) acc = extreme<kMin>(acc, c[k]);
      R[i] = acc;
    }
    __syncthreads();

    // 2. down the columns: out[row][col] over R[row .. row + 2r][col]
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int row = i / kTile, col = i - row * kTile;
      const int y = y0 + row, x = x0 + col;
      if (y >= h || x >= w) continue;
      const T* c = R + row * kTile + col;
      T acc = c[0];
      for (int k = 1; k <= 2 * r; ++k) acc = extreme<kMin>(acc, c[k * kTile]);
      dst[z * plane + static_cast<size_t>(y) * w + x] = acc;
    }
    __syncthreads();  // E and R are refilled for the next frame
  }
}

// dst[i] = ext of src's row over the clamped columns [x - r, x + r]
template <class T, bool kMin>
__global__ void __launch_bounds__(kThreads)
morph_rows_kernel(const T* __restrict__ src, size_t total, int w, int r,
                  T* __restrict__ dst) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    const int x = static_cast<int>(i % w);
    const T* row = src + (i - x);
    const int lo = max(0, x - r), hi = min(w - 1, x + r);
    T acc = row[lo];
    for (int k = lo + 1; k <= hi; ++k) acc = extreme<kMin>(acc, row[k]);
    dst[i] = acc;
  }
}

// dst[i] = ext of src's column over the clamped rows [y + yoff - r,
// y + yoff + r] of its h + 2*yoff rows
template <class T, bool kMin>
__global__ void __launch_bounds__(kThreads)
morph_cols_kernel(const T* __restrict__ src, size_t total, int h, int w,
                  int r, int yoff, T* __restrict__ dst) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const int hin = h + 2 * yoff;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t in_plane = static_cast<size_t>(hin) * w;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    const size_t z = i / plane, yx = i - z * plane;
    const int y = static_cast<int>(yx / w);
    const int x = static_cast<int>(yx - static_cast<size_t>(y) * w);
    const T* col = src + z * in_plane + x;  // row 0, column x
    const int lo = max(0, y + yoff - r), hi = min(hin - 1, y + yoff + r);
    T acc = col[static_cast<size_t>(lo) * w];
    for (int k = lo + 1; k <= hi; ++k) {
      acc = extreme<kMin>(acc, col[static_cast<size_t>(k) * w]);
    }
    dst[i] = acc;
  }
}

unsigned flat_blocks(size_t total) {
  return static_cast<unsigned>(
      std::min<size_t>((total + kThreads - 1) / kThreads, size_t{1} << 30));
}

// h output rows from sources of h + 2*yoff rows
template <class T, bool kMin>
int run(const T* src, int n, int h, int w, int r, int yoff, T* scratch,
        T* dst, cudaStream_t stream) {
  if (r <= kMorphMaxTileRadius) {
    const int e = kTile + 2 * r;
    const size_t bytes = static_cast<size_t>(e * e + e * kTile) * sizeof(T);
    return morph::launch_tiles(morph_tile_kernel<T, kMin>, bytes, n, h, w,
                               kTile, stream, src, n, h, w, r, yoff, dst);
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t total_in = static_cast<size_t>(n) * (h + 2 * yoff) * w;
  const size_t total = static_cast<size_t>(n) * h * w;
  morph_rows_kernel<T, kMin><<<flat_blocks(total_in), kThreads, 0, stream>>>(
      src, total_in, w, r, scratch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  morph_cols_kernel<T, kMin><<<flat_blocks(total), kThreads, 0, stream>>>(
      scratch, total, h, w, r, yoff, dst);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int morphology(const void* src, int n, int h, int w, int r, int yoff,
               int mode, void* scratch, void* dst, cudaStream_t stream) {
  const T* s = static_cast<const T*>(src);
  T* t = static_cast<T*>(scratch);
  T* d = static_cast<T*>(dst);
  return mode == 0 ? run<T, true>(s, n, h, w, r, yoff, t, d, stream)
                   : run<T, false>(s, n, h, w, r, yoff, t, d, stream);
}

int dispatch(const void* src, int n, int h, int w, int dtype, int r,
             int yoff, int mode, void* scratch, void* dst,
             cudaStream_t stream) {
  if (n < 1 || h < 1 || w < 1 || r < 0 || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case morph::kU8:
      return morphology<uint8_t>(src, n, h, w, r, yoff, mode, scratch, dst,
                                 stream);
    case morph::kI32:
      return morphology<int32_t>(src, n, h, w, r, yoff, mode, scratch, dst,
                                 stream);
    case morph::kF32:
      return morphology<float>(src, n, h, w, r, yoff, mode, scratch, dst,
                               stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// src, dst: n frames of (h, w), contiguous, of dtype code `dtype`
// (morph::Dtype); mode 0 erodes, 1 dilates. scratch: n*h*w elements, used
// (and needed) only when r > kMorphMaxTileRadius.
extern "C" int tpuimg_morphology(const void* src, int n, int h, int w,
                                 int dtype, int r, int mode, void* scratch,
                                 void* dst, cudaStream_t stream) {
  return dispatch(src, n, h, w, dtype, r, 0, mode, scratch, dst, stream);
}

// src: n blocks of (h + 2r, w) rows padded by r on each side; dst: n frames
// of (h, w); both contiguous. scratch: n*(h + 2r)*w elements, used (and
// needed) only when r > kMorphMaxTileRadius.
extern "C" int tpuimg_morphology_ypadded(const void* src, int n, int h,
                                         int w, int dtype, int r, int mode,
                                         void* scratch, void* dst,
                                         cudaStream_t stream) {
  return dispatch(src, n, h, w, dtype, r, r, mode, scratch, dst, stream);
}
