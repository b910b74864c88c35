// Grayscale erode (min) and dilate (max) over a (2r+1)^2 square structuring
// element, replicate border, of a batch of u8, int32 or float32 frames.
//
// Replaces tpuimg/kernels/sep_stencil.py::morphology_pallas (:575; band
// kernel _make_kernel :206 in _sep_stencil :272, with the doubling-window
// extremes of tpuimg/kernels/window.py:39). The TPU widens u8 to bf16 for
// its (8, 128) tiles and streams row bands with halo views; here every
// dtype is computed natively (min and max are exact in any type). For a min
// or max the replicate border is the truncated window:
//   out[y, x] = ext over rows [max(0, y-r), min(h-1, y+r)]
//                      x cols [max(0, x-r), min(w-1, x+r)],
// every replicated pixel being inside that window already, so positions
// outside the frame hold the pass's identity (+inf/-inf, INT_MAX/INT_MIN,
// 255/0). The caller passes r = min(radius, max(h, w) - 1), which gives the
// same result.
//
// Two routes, chosen by r in the one C call:
// - the tile route, up to r = 191 for u8 and 96 for int32 and float32
//   (morph_tile below, mirrored by kernels/sep_stencil.py::morph_tile): one
//   launch over T x T output tiles of one frame (gridDim.z over the
//   frames). The tile's (T + 2r)^2 extent is staged in shared memory, then
//   one van Herk/Gil-Werman pass along the rows and one down the columns
//   (morph.cuh window_pass, shared with open_close.cu: about 3 compares and
//   5 shared accesses an output at any radius), u8 four to a word down the
//   columns (__vminu4/__vmaxu4), then the tile out, u8 as words.
//   - T is the largest of 128, 64, 32, 16 whose footprint lets two blocks
//     share an SM, unless the largest that fits a block stages less than
//     half as much an output: 128 for u8 and 64 for int32/float32 at r = 15
//     (the extent 1.5x and 2.2x the outputs). A frame that leaves SMs short
//     of two blocks takes halved tiles (1080p, a shard's block).
//   - The extent's loads are all in flight at once: 4-byte elements by
//     cp.async; u8 a word a thread (inside the frame the aligned words that
//     hold it, realigned with funnel shifts), four words read before any is
//     stored. Staged a row a warp, as the tile kernel it replaces did, each
//     warp waited on its rows' loads one after another.
// - larger r: a row pass into `scratch` and a column pass out of it, two
//   launches of one thread per pixel reading its clamped window from device
//   memory (L1/L2 hits), so every radius is exact.
// Bound: bytes (one element read and one written a pixel; the compares,
// packed four to an operation for u8, take less). What held the tile kernel
// this replaces at 31x its bound (u8 erode r15 at 4K, 0.1555 ms against
// 0.0050, NVIDIA H100 80GB HBM3, 700.00 W) was two direct (2r + 1)-tap loops
// over 32x32 tiles: ~90 shared loads and compares an output at r = 15, u8 a
// byte at a time. This design is latency-bound in turn: one wave of blocks,
// each staging, then running two window passes whose items are chains of
// dependent shared accesses, then writing (u8 erode r15 at 4K 0.031 ms on
// an NVIDIA H100 80GB HBM3 at 700.00 W, chip_smoke.py).
//
// A second entry, tpuimg_morphology_ypadded, replaces
// tpuimg/kernels/sep_stencil.py::morph_pallas_ypadded (:594, pallas_call
// :417 in _sep_stencil_ypadded :371): a shard's block whose rows already
// carry r halo rows on each side, (h + 2r, w) in and (h, w) out. Output row
// y takes the extreme over block rows y .. y + 2r (no border in y) and the
// truncated columns, so both routes run with a row offset `yoff` = r into a
// source of h + 2*yoff rows: the tile route stages rows from y0 on, the
// column pass reads rows [y, y + 2r]. The radius is the block's own; it is
// never shrunk to the frame (the block's height is fixed at h + 2r).
#include <algorithm>

#include "morph.cuh"

namespace {

using morph::ColUnit;
using morph::extreme;
using morph::identity;
using morph::kThreads;
using morph::row_words;
using morph::window_pass;

// the tile sides, largest first, and the footprint under which two blocks
// share an SM (half of its 228 KB, less the 1 KB the card keeps for each
// block)
constexpr int kTiles[] = {128, 64, 32, 16};
constexpr long long kPairBytes = 233472 / 2 - 1024;

// The tile's geometry: e rows (and columns) of the staged extent, and the
// two buffers' row strides in words (pa: the extent's, pb: the rows of tile
// columns the row pass leaves).
struct MorphGeom {
  int e, pa, pb;
  __host__ __device__ MorphGeom(int tile, int r, int size)
      : e(tile + 2 * r),
        pa(row_words(tile + 2 * r, size)),
        pb(row_words(tile, size)) {}
  __host__ __device__ long long bytes() const {
    return 4LL * e * (pa + pb);
  }
};

// Tiles narrower than kWideTile stage over 9x their outputs at the radii
// that need them and lose to the two-pass route there (tools/stencil_ab.py
// times the routes by radius); they run only up to the r = 96 the earlier
// 32x32 tiles reached.
constexpr int kWideTile = 64;
constexpr int kNarrowMaxRadius = 96;

// the tile side at radius r for elements of `size` bytes, 0 past the tile
// route (kernels/sep_stencil.py::morph_tile is its copy): the largest of
// kTiles whose footprint lets two blocks share an SM, unless the largest
// that fits a block stages less than half as much an output ((t + 2r)^2 /
// t^2: the two-block tile is the smaller at large radii); no tile narrower
// than kWideTile past kNarrowMaxRadius
int morph_tile(int r, int size) {
  int pair = 0, big = 0;
  for (const int t : kTiles) {
    const long long b = MorphGeom(t, r, size).bytes();
    if (b <= kMaxSmemBytes && big == 0) big = t;
    if (b <= kPairBytes && pair == 0) pair = t;
  }
  int t = pair;
  if (pair == 0) {
    t = big;
  } else {
    const long long ep = pair + 2LL * r, eb = big + 2LL * r;
    if (2 * eb * eb * pair * pair < ep * ep * big * big) t = big;
  }
  return t < kWideTile && r > kNarrowMaxRadius ? 0 : t;
}

// a frame that gives fewer blocks than this many an SM takes smaller tiles
constexpr int kMinBlocksPerSm = 2;
// words a thread reads before it stores any of them (u8 rows that do not
// come by cp.async)
constexpr int kBatch = 4;

// Word j of extent row ey, bytes from source row ys + ey and columns
// xs + 4j .., the identity outside the frame. A row inside the frame comes
// in as the aligned words that hold it, realigned with a funnel shift
// (every word read holds one of the row's e bytes, so none reads past the
// allocation).
template <bool kMin>
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ sz,
                                              int hin, int w, int ys, int xs,
                                              int e, int ey, int j) {
  const int y = ys + ey;
  if (y < 0 || y >= hin) return identity<kMin, uint32_t>();
  const uint8_t* srow = sz + static_cast<size_t>(y) * w;
  if (xs >= 0 && xs + e <= w) {
    const uint8_t* s = srow + xs;
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(s) & 3);
    const uint32_t* base = reinterpret_cast<const uint32_t*>(s - off);
    const uint32_t lo = base[j];
    const uint32_t hi = (off != 0 && 4 * (j + 1) < off + e) ? base[j + 1] : 0u;
    return __funnelshift_r(lo, hi, 8 * off);
  }
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int x = xs + 4 * j + b;
    const uint32_t byte =
        (x >= 0 && x < w) ? srow[x] : identity<kMin, uint8_t>();
    v |= byte << (8 * b);
  }
  return v;
}

// The extent, e rows of e elements from source rows ys .. and columns
// xs .., into A (row stride pa elements), the identity outside the frame.
// Items go row-major, kThreads a step, their (row, unit) advanced by
// counters instead of divisions. In-frame 4-byte elements come by cp.async
// (the caller waits for them), so a block has all its loads in flight at
// once; u8 comes a word a thread, kBatch words read before any is stored.
template <class T, bool kMin>
__device__ __forceinline__ void stage_extent(const T* __restrict__ sz, int hin,
                                             int w, int ys, int xs, int e,
                                             int pa, T* A) {
  constexpr int kPer = ColUnit<T>::kPer;
  const int nu = (e + kPer - 1) / kPer;  // units a row
  const int dq = kThreads / nu, dj = kThreads - dq * nu;
  int ey = threadIdx.x / nu, j = threadIdx.x - ey * nu;
  if constexpr (sizeof(T) == 4) {
    while (ey < e) {
      const int y = ys + ey, x = xs + j;
      T* d = A + ey * pa + j;
      if (y >= 0 && y < hin && x >= 0 && x < w) {
        cp_async4(d, sz + static_cast<size_t>(y) * w + x);
      } else {
        *d = identity<kMin, T>();
      }
      ey += dq;
      j += dj;
      if (j >= nu) {
        j -= nu;
        ++ey;
      }
    }
  } else {
    uint32_t* Aw = reinterpret_cast<uint32_t*>(A);
    const int pw = pa / 4;  // words a row
    while (ey < e) {
      uint32_t v[kBatch];
      int at[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        at[b] = -1;
        if (ey < e) {
          v[b] = load_word<kMin>(sz, hin, w, ys, xs, e, ey, j);
          at[b] = ey * pw + j;
        }
        ey += dq;
        j += dj;
        if (j >= nu) {
          j -= nu;
          ++ey;
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (at[b] >= 0) Aw[at[b]] = v[b];
      }
    }
  }
}

// d[0 .. n) = row[0 .. n); u8 as words where d is word-aligned
template <class T>
__device__ __forceinline__ void write_out(const T* row, int n, T* d,
                                          int lane) {
  for (int c = lane; c < n; c += 32) d[c] = row[c];
}
template <>
__device__ __forceinline__ void write_out<uint8_t>(const uint8_t* row, int n,
                                                   uint8_t* d, int lane) {
  if ((reinterpret_cast<uintptr_t>(d) & 3) == 0) {
    const uint32_t* rw = reinterpret_cast<const uint32_t*>(row);
    uint32_t* dw = reinterpret_cast<uint32_t*>(d);
    for (int j = lane; j < n >> 2; j += 32) dw[j] = rw[j];
    for (int c = (n & ~3) + lane; c < n; c += 32) d[c] = row[c];
  } else {
    for (int c = lane; c < n; c += 32) d[c] = row[c];
  }
}

// at least two blocks an SM (nvcc takes 56-64 registers, no spills)
template <class T, bool kMin>
__global__ void __launch_bounds__(kThreads, 2)
morph_tile_kernel(const T* __restrict__ src, int n, int h, int w, int r,
                  int yoff, int tile, T* __restrict__ dst) {
  using U = typename ColUnit<T>::U;
  constexpr int kPer = ColUnit<T>::kPer;
  constexpr int kPerWord = 4 / sizeof(T);  // elements a word
  extern __shared__ __align__(16) uint32_t smem_words[];
  const MorphGeom g(tile, r, sizeof(T));
  const int k = 2 * r + 1;
  const int pa = g.pa * kPerWord, pb = g.pb * kPerWord;  // in elements
  // A: the extent (e x e, stride pa); then the output tile (t x t, stride
  // pb). B: the row pass (e x t, stride pb).
  T* A = reinterpret_cast<T*>(smem_words);
  T* B = reinterpret_cast<T*>(smem_words + g.e * g.pa);
  const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  const int hin = h + 2 * yoff;  // rows of a source frame
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t in_plane = static_cast<size_t>(hin) * w;
  const int wcols = tile / kPer;  // column units of a B row

  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    // the extent: source rows y0 + yoff - r .., columns x0 - r .., the
    // identity outside the frame
    stage_extent<T, kMin>(src + z * in_plane, hin, w, y0 + yoff - r, x0 - r,
                          g.e, pa, A);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // along the rows: B[row][c] over A[row][c .. c + 2r]
    window_pass<kMin, T>(A, pa, 1, B, pb, 1, g.e, tile, k);
    __syncthreads();
    // down the columns: A[i][c] over B[i .. i + 2r][c], i < t
    window_pass<kMin, U>(reinterpret_cast<const U*>(B), 1, g.pb,
                         reinterpret_cast<U*>(A), 1, g.pb, wcols, tile, k);
    __syncthreads();
    // the tile out, a warp a row
    const int cols = min(tile, w - x0);
    for (int i = warp; i < tile; i += kWarps) {
      const int y = y0 + i;
      if (y >= h) break;
      write_out(A + i * pb, cols,
                dst + z * plane + static_cast<size_t>(y) * w + x0, lane);
    }
    __syncthreads();  // A and B are refilled for the next frame
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
  int tile = morph_tile(r, sizeof(T));
  if (tile > 0) {
    // halve the tile while the grid leaves SMs short of kMinBlocksPerSm
    // blocks (a shard's block of a few hundred rows)
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    auto blocks = [&](int t) {
      const dim3 grid = morph::tile_grid(n, h, w, t);
      return static_cast<long long>(grid.x) * grid.y * grid.z;
    };
    while (tile > kTiles[3] && blocks(tile) < 1LL * kMinBlocksPerSm * sms) {
      tile /= 2;
    }
    const size_t bytes =
        static_cast<size_t>(MorphGeom(tile, r, sizeof(T)).bytes());
    return morph::launch_tiles(morph_tile_kernel<T, kMin>, bytes, n, h, w,
                               tile, stream, src, n, h, w, r, yoff, tile,
                               dst);
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
// (and needed) only past the tile route (tpuimg_morph_tile returns 0).
extern "C" int tpuimg_morphology(const void* src, int n, int h, int w,
                                 int dtype, int r, int mode, void* scratch,
                                 void* dst, cudaStream_t stream) {
  return dispatch(src, n, h, w, dtype, r, 0, mode, scratch, dst, stream);
}

// src: n blocks of (h + 2r, w) rows padded by r on each side; dst: n frames
// of (h, w); both contiguous. scratch: n*(h + 2r)*w elements, used (and
// needed) only past the tile route.
extern "C" int tpuimg_morphology_ypadded(const void* src, int n, int h,
                                         int w, int dtype, int r, int mode,
                                         void* scratch, void* dst,
                                         cudaStream_t stream) {
  return dispatch(src, n, h, w, dtype, r, r, mode, scratch, dst, stream);
}

// the tile route's side at radius r for elements of `size` bytes, 0 past
// it (the host's copy is kernels/sep_stencil.py::morph_tile)
extern "C" int tpuimg_morph_tile(int r, int size) {
  return morph_tile(r, size);
}
