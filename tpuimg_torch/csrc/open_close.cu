// Fused morphological open (erode then dilate) and close (dilate then
// erode), square structuring element of side 2r+1, replicate border, of a
// batch of u8, int32 or float32 frames, in one launch.
//
// Replaces tpuimg/kernels/sep_stencil.py::open_close_pallas (:509;
// _open_close :478, kernel _open_close_kernel :436). The stage-1 result
// never reaches device memory. The composed op's replicate border acts on
// the stage-1 result (sep_stencil.py:441-445): stage 2 reads stage 1 only at
// in-frame positions, clamped.
//
// The replicate border of a min or max is the truncated window: a clamped
// index repeats an edge value the window already holds. So each stage is its
// 1-D extreme along the rows and down the columns, each over the part of the
// window inside the frame, and the four passes (stage 1's row and column
// passes commute, as do stage 2's) run as: stage 1 along the rows; stage 1
// down the columns, then stage 2 down the columns (a 1-D opening or closing
// of each column); stage 2 along the rows. Positions outside the frame hold
// the identity of the pass that reads them (+inf/-inf, INT_MAX/INT_MIN,
// 255/0), which is what truncation means. NaN propagates as morph::extreme
// does, in any order, so the values equal open_close_plain's (+0 and -0 may
// come out either way).
//
// What held the tile kernel this replaces at 127x its bound (1.2534 ms
// against 0.0099 for open r15 on 2x2160x3840 u8, NVIDIA H100 80GB HBM3,
// 700.00 W) was on-chip work: four direct (2r+1)-tap loops (~380 shared
// loads and compares a pixel at r = 15), a 32x32 tile re-staging a
// (32 + 4r)^2 extent, u8 compared a byte at a time, divisions in every loop.
// This design:
// - Window extremes by van Herk/Gil-Werman: a thread takes one window's
//   worth (2r + 1) of outputs of one line, runs the suffix extremes of its
//   block of inputs backwards, then the prefix extremes of the next block
//   forwards: about 3 compares and 5 shared accesses an output at any r.
// - Tiles of T x T outputs, T the largest of 128, 64, 32, 16 whose workspace
//   fits (the host's planner, kernels/sep_stencil.py::open_close_tile, which
//   prefers a footprint that lets two blocks share an SM): 128 for u8 and 64
//   for int32/float32 at r = 15, so the (T + 4r)^2 staged extent is 2.2x
//   (u8) and 3.8x the outputs, not 8.3x.
// - u8 down the columns four to a 32-bit word, with __vminu4/__vmaxu4.
// - Threads take (line, block) items line-fastest, with counters instead of
//   divisions; odd word strides keep the row passes' lanes in distinct banks.
// Shared memory: (T + 4r) rows of (T + 4r) and of (T + 2r) elements, each
// row an odd number of words. The ceiling is the radius whose 16x16 tile
// still fits a block's 227 KB: r = 44 for int32/float32, 93 for u8; above,
// the wrapper composes two morphology.cu launches, as tpuimg composes two
// kernels for frames wider than its lane limit (sep_stencil.py:518-520).
// Bound: bytes (one element read and one written a pixel, half the composed
// form's traffic; the compares, packed four to an operation for u8, take
// less): 0.0099 ms for open r15 on 2x2160x3840 u8, which this kernel runs in
// 0.1248 ms on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py; two
// morphology.cu launches 0.6054, f32 0.5574), 48 registers for u8 and 80 for
// int32/float32, no spills.
#include "morph.cuh"

namespace {

using morph::ColUnit;
using morph::ext;
using morph::identity;
using morph::kThreads;
using morph::row_words;
using morph::window_pass;

// The tile's geometry: e rows (and columns) of the staged extent, w2 the
// columns of the stage-1 result stage 2 reads, and the two buffers' row
// strides in words (pa: the extent's, pb: the narrower rows').
struct OcGeom {
  int e, w2, pa, pb;
  __host__ __device__ OcGeom(int tile, int r, int size)
      : e(tile + 4 * r),
        w2(tile + 2 * r),
        pa(row_words(tile + 4 * r, size)),
        pb(row_words(tile + 2 * r, size)) {}
  __host__ __device__ long long bytes() const {
    return 4LL * e * (pa + pb);
  }
};

// two blocks an SM: 128 registers a thread; at nvcc's own choice the int32
// instances spilled 12 bytes
template <class T, bool kMinFirst>
__global__ void __launch_bounds__(kThreads, 2)
open_close_kernel(const T* __restrict__ src, int n, int h, int w, int r,
                  int tile, T* __restrict__ dst) {
  using U = typename ColUnit<T>::U;
  constexpr int kPer = ColUnit<T>::kPer;
  constexpr bool kMin2 = !kMinFirst;
  constexpr int kPerWord = 4 / sizeof(T);  // elements a word
  extern __shared__ __align__(16) uint32_t smem_words[];
  const OcGeom g(tile, r, sizeof(T));
  const int k = 2 * r + 1;
  const int pa = g.pa * kPerWord, pb = g.pb * kPerWord;  // in elements
  // A: the extent (e x e, stride pa); then stage 1 after both passes
  // ((t + 2r) x w2, stride pb); then the output tile (t x t, stride pb).
  // B: stage 1 along the rows (e x w2, stride pb); then both stages down
  // the columns (t x w2, stride pb).
  T* A = reinterpret_cast<T*>(smem_words);
  T* B = reinterpret_cast<T*>(smem_words + g.e * g.pa);
  const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const size_t plane = static_cast<size_t>(h) * w;
  // column units of a B row; a unit is a word, so rows are g.pb units apart
  const int wcols = (g.w2 + kPer - 1) / kPer;

  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    const T* sz = src + z * plane;
    // the extent: rows y0 - 2r .., columns x0 - 2r .., stage 1's identity
    // outside the frame
    for (int ey = warp; ey < g.e; ey += kWarps) {
      const int y = y0 - 2 * r + ey;
      T* row = A + ey * pa;
      if (y < 0 || y >= h) {
        for (int ex = lane; ex < g.e; ex += 32) {
          row[ex] = identity<kMinFirst, T>();
        }
        continue;
      }
      const T* srow = sz + static_cast<size_t>(y) * w;
      for (int ex = lane; ex < g.e; ex += 32) {
        const int x = x0 - 2 * r + ex;
        row[ex] = (x >= 0 && x < w) ? srow[x] : identity<kMinFirst, T>();
      }
    }
    __syncthreads();

    // stage 1 along the rows: B[row][c] over A[row][c .. c + 2r]
    window_pass<kMinFirst, T>(A, pa, 1, B, pb, 1, g.e, g.w2, k);
    __syncthreads();
    // stage 1 down the columns: A[j][c] over B[j .. j + 2r][c], j < t + 2r
    window_pass<kMinFirst, U>(reinterpret_cast<const U*>(B), 1, g.pb,
                              reinterpret_cast<U*>(A), 1, g.pb, wcols,
                              tile + 2 * r, k);
    __syncthreads();
    // stage-1 rows outside the frame: stage 2's identity (its border acts
    // on in-frame stage-1 values only)
    {
      const int lo = min(max(r - y0, 0), tile + 2 * r);   // rows j < lo
      const int hi = max(min(h - y0 + r, tile + 2 * r), lo);  // and >= hi
      for (int j = warp; j < tile + 2 * r; j += kWarps) {
        if (j >= lo && j < hi) continue;
        U* row = reinterpret_cast<U*>(A + j * pb);
        for (int c = lane; c < wcols; c += 32) row[c] = identity<kMin2, U>();
      }
    }
    __syncthreads();
    // stage 2 down the columns: B[i][c] over A[i .. i + 2r][c], i < t
    window_pass<kMin2, U>(reinterpret_cast<const U*>(A), 1, g.pb,
                          reinterpret_cast<U*>(B), 1, g.pb, wcols, tile, k);
    __syncthreads();
    // columns outside the frame: stage 2's identity, for its row pass
    {
      const int lo = min(max(r - x0, 0), g.w2);          // columns c < lo
      const int hi = max(min(w - x0 + r, g.w2), lo);     // and >= hi
      const int nbad = lo + g.w2 - hi;
      if (nbad > 0) {
        for (int i = warp; i < tile; i += kWarps) {
          for (int m = lane; m < nbad; m += 32) {
            B[i * pb + (m < lo ? m : hi + m - lo)] = identity<kMin2, T>();
          }
        }
      }
    }
    __syncthreads();
    // stage 2 along the rows: A[i][col] over B[i][col .. col + 2r]
    window_pass<kMin2, T>(B, pb, 1, A, pb, 1, tile, tile, k);
    __syncthreads();
    // the tile out, a warp a row
    for (int i = warp; i < tile; i += kWarps) {
      const int y = y0 + i;
      if (y >= h) break;
      T* drow = dst + z * plane + static_cast<size_t>(y) * w;
      const T* row = A + i * pb;
      for (int c = lane; c < tile; c += 32) {
        if (x0 + c < w) drow[x0 + c] = row[c];
      }
    }
    __syncthreads();  // A and B are refilled for the next frame
  }
}

template <class T>
int open_close(const void* src, int n, int h, int w, int r, int tile,
               int mode, void* dst, cudaStream_t stream) {
  const OcGeom g(tile, r, sizeof(T));
  if (g.bytes() > kMaxSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = static_cast<size_t>(g.bytes());
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  return mode == 0 ? morph::launch_tiles(open_close_kernel<T, true>, bytes, n,
                                         h, w, tile, stream, s, n, h, w, r,
                                         tile, d)
                   : morph::launch_tiles(open_close_kernel<T, false>, bytes,
                                         n, h, w, tile, stream, s, n, h, w, r,
                                         tile, d);
}

}  // namespace

// src, dst: n frames of (h, w), contiguous, of dtype code `dtype`
// (morph::Dtype); mode 0 opens (erode first), 1 closes (dilate first);
// tile: 16, 32, 64 or 128 (kernels/sep_stencil.py::open_close_tile), whose
// workspace at radius r must fit a block's shared memory.
extern "C" int tpuimg_open_close(const void* src, int n, int h, int w,
                                 int dtype, int r, int tile, int mode,
                                 void* dst, cudaStream_t stream) {
  if (n < 1 || h < 1 || w < 1 || r < 0 || (mode != 0 && mode != 1) ||
      (tile != 16 && tile != 32 && tile != 64 && tile != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case morph::kU8:
      return open_close<uint8_t>(src, n, h, w, r, tile, mode, dst, stream);
    case morph::kI32:
      return open_close<int32_t>(src, n, h, w, r, tile, mode, dst, stream);
    case morph::kF32:
      return open_close<float>(src, n, h, w, r, tile, mode, dst, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
