// Separable gaussian blur of a batch of float32 frames, reflect-101 border,
// OpenCV weights (taps from the host, tpuimg_torch/core/kernelgen.py).
//
// Replaces tpuimg/kernels/sep_stencil.py::gaussian_pallas (:542; band
// kernel _make_kernel, pallas_call :311 in _sep_stencil :272, and the
// row-padded route _sep_stencil_ypadded :371 for unaligned r > 16). The TPU
// streams row bands with halo views, widens lanes to 128 and splits wide
// frames into column strips; none of that carries over.
//
// A second entry, tpuimg_gaussian_ypadded, replaces gaussian_pallas_ypadded
// (:551, pallas_call :417 in _sep_stencil_ypadded :371): a shard's block
// whose rows already carry r halo rows on each side, (h + 2r, w) in and
// (h, w) out. Output row y reads block rows y .. y + 2r, so its extent's
// rows are the block's own (clamped past its end, which only feeds outputs
// that are not written) instead of reflected ones; x is still reflect-101
// in the kernel. Everything else is the one kernel body. tpuimg's column
// strips for w > 4096 are a TPU lane limit; this kernel takes any width.
//
// Every output is the symmetric form w[r]*c + sum_i w[r-i]*(left_i +
// right_i), along the rows and then down the columns, in the plain
// version's order; every multiply and add is rounded on its own
// (__fmul_rn/__fadd_rn), so nvcc cannot contract them into FMAs and both
// entries equal the plain PyTorch versions bit for bit.
//
// Bound: bytes, 8 a pixel (one float read, one written): 0.0198 ms at 4K.
// What held the tile kernel this replaces at 3.9x that bound (0.0778 ms,
// NVIDIA H100 80GB HBM3, 700.00 W) was latency and staging: 8,100 short
// blocks of 32x32 outputs at 4K, each rebuilding its taps and reflect
// tables, staging a misaligned extent one 4-byte load an element through
// two table reads, and running both passes out of shared memory between
// barriers, with nothing overlapping the next tile's loads.
//
// This design, for r <= kRegMaxRadius (16):
// - Tiles of 32 rows by 128 columns, a thread a column, in persistent
//   blocks: one wave of the blocks the card holds at the footprint
//   (occupancy API), each walking the tiles blockIdx.x, + gridDim.x, ...
//   (columns fastest, so neighbours share their halo in L2) and staging the
//   next tile's extent with cp.async into a second buffer while it computes
//   the current one.
// - The extent is (32 + 2r) rows by 128 + 2*ra columns, ra = r rounded up
//   to 4, so a row of a tile whose extent lies inside the frame comes in as
//   16-byte copies wherever its address is 16-byte aligned. A row at a frame
//   edge, or misaligned (a width not a multiple of 4, a base with a storage
//   offset), comes in 4 bytes an element through the iterated reflect-101
//   map (common.cuh::reflect101_fast), so frames smaller than the halo stay
//   exact. Nothing is copied or padded in device memory.
// - Row pass and column pass in registers: each thread walks down its
//   column, computes the row pass of each extent row from 2r + 1 shared
//   loads and slides it into a window of 2r + 1 registers, from which the
//   column pass takes each output. A row-pass value never goes back to
//   shared memory. The window's size is a template parameter: r 1-4 have
//   instances of their own, r 5-8 and 9-16 run the 8 and 16 instances with
//   the taps past r switched off.
// Shared memory: two extents and the taps, 39,188 bytes at r = 2.
//
// r 17-96 keep the earlier tile body: one block per 32x32 output tile,
// the (32 + 2r)^2 extent staged through reflect tables, both passes out of
// shared memory. Shared memory is (32 + 2r)^2 + 32(32 + 2r) + 2r + 1
// floats and 2(32 + 2r) ints; at r = 96 that is 231,940 bytes, the largest
// radius under the 227 KB (232,448 bytes) a block may use. Larger radii are
// refused (kGaussMaxRadius).
#include <algorithm>

#include "common.cuh"

constexpr int kGaussMaxRadius = 96;
constexpr int kGaussMaxTaps = 2 * kGaussMaxRadius + 1;

// the taps travel by value in the launch's parameter space (772 bytes):
// no device buffer, no host-to-device copy before the launch
struct GaussTaps {
  float w[kGaussMaxTaps];
};

namespace {

// ---- the register route, r <= kRegMaxRadius ----

constexpr int kRegMaxRadius = 16;
constexpr int kTw = 128;  // a tile's output columns, a thread each
constexpr int kTh = 32;   // a tile's output rows

// The staged extent of a tile at radius r: ra halo columns on each side (r
// rounded up to 4, so rows stay 16-byte aligned), eh rows, ew columns.
struct GaussGeom {
  int ra, eh, ew;
  __host__ __device__ explicit GaussGeom(int r)
      : ra((r + 3) & ~3), eh(kTh + 2 * r), ew(kTw + 2 * ((r + 3) & ~3)) {}
  __host__ __device__ int floats() const { return eh * ew; }
  // two extents and the 2r + 1 taps
  __host__ __device__ size_t bytes(int r) const {
    return static_cast<size_t>(2 * floats() + 2 * r + 1) * 4;
  }
};

// KR: the register window's radius; kExact: r is KR (else r <= KR comes at
// run time and the taps past it are switched off).
template <int KR, bool kExact, bool kYPadded>
__global__ void __launch_bounds__(kTw, 4)
gauss_reg_kernel(const float* __restrict__ src, int n, int h, int w,
                 const GaussTaps taps, int r_arg, float* __restrict__ dst) {
  extern __shared__ __align__(16) float smem[];
  const int r = kExact ? KR : r_arg;
  const GaussGeom g(r);
  float* W = smem + 2 * g.floats();
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * r + 1; i += kTw) W[i] = taps.w[i];
  const int hin = kYPadded ? h + 2 * r : h;  // rows of a source frame
  const int ntx = (w + kTw - 1) / kTw;
  const long long per = static_cast<long long>(ntx) * ((h + kTh - 1) / kTh);
  const long long total = per * n;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t in_plane = static_cast<size_t>(hin) * w;
  // the staging items: 4-float pieces of the extent, n4 a row, kTw a step
  const int n4 = g.ew / 4;
  const int dq = kTw / n4, dv = kTw - dq * n4;
  const int q1 = tid / n4, v1 = tid - q1 * n4;

  // tile t: frame z, output rows y0 .., columns x0 ..
  auto tile_of = [&](long long t, int* z, int* y0, int* x0) {
    *z = static_cast<int>(t / per);
    const int rem = static_cast<int>(t - *z * per);
    const int ty = rem / ntx;
    *y0 = ty * kTh;
    *x0 = (rem - ty * ntx) * kTw;
  };
  // E = the extent of tile t, by cp.async
  auto stage = [&](long long t, float* E) {
    int z, y0, x0;
    tile_of(t, &z, &y0, &x0);
    const float* sz = src + z * in_plane;
    const int xs = x0 - g.ra;
    const bool inside = xs >= 0 && xs + g.ew <= w;
    int q = q1, v = v1;
    while (q < g.eh) {
      const int sy = kYPadded ? min(y0 + q, hin - 1)
                              : reflect101_fast(y0 - r + q, h);
      const float* srow = sz + static_cast<size_t>(sy) * w;
      float* d = E + q * g.ew + 4 * v;
      const int x = xs + 4 * v;
      if (inside && (reinterpret_cast<uintptr_t>(srow + x) & 15) == 0) {
        cp_async16(d, srow + x);
      } else {
        for (int j = 0; j < 4; ++j) {
          cp_async4(d + j, srow + reflect101_fast(x + j, w));
        }
      }
      q += dq;
      v += dv;
      if (v >= n4) {
        v -= n4;
        ++q;
      }
    }
  };

  long long t = blockIdx.x;
  if (t < total) stage(t, smem);
  cp_async_commit();
  __syncthreads();  // W
  float wk[KR + 1];  // wk[k] = w[r - k]
#pragma unroll
  for (int k = 0; k <= KR; ++k) wk[k] = (kExact || k <= r) ? W[r - k] : 0.f;

  for (int i = 0; t < total; ++i, t += gridDim.x) {
    const float* E = smem + (i & 1) * g.floats();
    if (t + gridDim.x < total) {
      stage(t + gridDim.x, smem + ((i + 1) & 1) * g.floats());
    }
    cp_async_commit();
    cp_async_wait_one();  // this tile's extent
    __syncthreads();

    int z, y0, x0;
    tile_of(t, &z, &y0, &x0);
    const int rows = min(kTh, h - y0);
    const bool live = x0 + tid < w;
    const float* e = E + g.ra + tid;  // this column in extent row 0
    float* out = dst + z * plane + static_cast<size_t>(y0) * w + x0 + tid;
    float win[2 * KR + 1];  // row-pass values of rows o - KR .. o + KR
#pragma unroll
    for (int m = 0; m <= 2 * KR; ++m) win[m] = 0.f;
    // s: the window's newest row, relative to y0 - KR; extent row q
    for (int s = 0; s < kTh + 2 * KR; ++s) {
      const int q = s - KR + r;
      float v = 0.f;
      if (kExact || (q >= 0 && q < g.eh)) {
        const float* c = e + q * g.ew;
        v = __fmul_rn(wk[0], c[0]);
#pragma unroll
        for (int k = 1; k <= KR; ++k) {
          if (kExact || k <= r) {
            v = __fadd_rn(v, __fmul_rn(wk[k], __fadd_rn(c[-k], c[k])));
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2 * KR; ++m) win[m] = win[m + 1];
      win[2 * KR] = v;
      const int o = s - 2 * KR;  // the output row centred in the window
      if (o >= 0 && o < rows && live) {
        float acc = __fmul_rn(wk[0], win[KR]);
#pragma unroll
        for (int k = 1; k <= KR; ++k) {
          if (kExact || k <= r) {
            acc = __fadd_rn(acc, __fmul_rn(wk[k], __fadd_rn(win[KR - k],
                                                            win[KR + k])));
          }
        }
        out[static_cast<size_t>(o) * w] = acc;
      }
    }
    __syncthreads();  // E is refilled two tiles on
  }
}

// Raise the kernel's shared memory to `bytes` and launch one wave of the
// blocks the card holds at that footprint, each tile count balanced.
template <class K>
int launch_reg(K kernel, size_t bytes, const float* src, int n, int h, int w,
               const GaussTaps& taps, int r, float* dst,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTw,
                                                        bytes);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the caller gets the code
    return static_cast<int>(err);
  }
  const long long total = static_cast<long long>((w + kTw - 1) / kTw) *
                          ((h + kTh - 1) / kTh) * n;
  long long blocks = std::min<long long>(
      total, std::max(1LL, static_cast<long long>(sms) * per_sm));
  const long long each = (total + blocks - 1) / blocks;
  blocks = (total + each - 1) / each;
  kernel<<<static_cast<unsigned>(blocks), kTw, bytes, stream>>>(
      src, n, h, w, taps, r, dst);
  return static_cast<int>(cudaGetLastError());
}

template <bool kYPadded>
int run_reg(const float* src, int n, int h, int w, const GaussTaps& taps,
            int r, float* dst, cudaStream_t stream) {
  const size_t bytes = GaussGeom(r).bytes(r);
  switch (r) {
    case 1:
      return launch_reg(gauss_reg_kernel<1, true, kYPadded>, bytes, src, n, h,
                        w, taps, r, dst, stream);
    case 2:
      return launch_reg(gauss_reg_kernel<2, true, kYPadded>, bytes, src, n, h,
                        w, taps, r, dst, stream);
    case 3:
      return launch_reg(gauss_reg_kernel<3, true, kYPadded>, bytes, src, n, h,
                        w, taps, r, dst, stream);
    case 4:
      return launch_reg(gauss_reg_kernel<4, true, kYPadded>, bytes, src, n, h,
                        w, taps, r, dst, stream);
    default:
      return r <= 8 ? launch_reg(gauss_reg_kernel<8, false, kYPadded>, bytes,
                                 src, n, h, w, taps, r, dst, stream)
                    : launch_reg(gauss_reg_kernel<16, false, kYPadded>, bytes,
                                 src, n, h, w, taps, r, dst, stream);
  }
}

// ---- the tile route, r 17 .. kGaussMaxRadius ----

constexpr int kTile = 32;
constexpr int kThreads = 256;

// floats, then the two index tables (4-byte ints)
__host__ __device__ int gauss_smem_words(int r) {
  const int ext = kTile + 2 * r;
  return ext * ext + ext * kTile + 2 * r + 1 + 2 * ext;
}

// kYPadded: src frames are (h + 2r, w) blocks whose rows are already padded
template <bool kYPadded>
__global__ void __launch_bounds__(kThreads)
gauss_tile_kernel(const float* __restrict__ src, int n, int h, int w,
                  const GaussTaps taps, int r, float* __restrict__ dst) {
  extern __shared__ float smem[];
  const int ext = kTile + 2 * r;
  float* E = smem;             // ext x ext: input extent
  float* R = E + ext * ext;    // ext x kTile: row pass
  float* W = R + ext * kTile;  // 2r + 1 taps
  int* YS = reinterpret_cast<int*>(W + 2 * r + 1);  // ext reflected rows
  int* XS = YS + ext;                               // ext reflected columns
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * r + 1; i += kThreads) W[i] = taps.w[i];
  const int hin = kYPadded ? h + 2 * r : h;  // rows of a source frame
  if (kYPadded) {
    clamped_table(y0, ext, hin, YS);
  } else {
    reflect101_table(y0 - r, ext, h, YS);
  }
  reflect101_table(x0 - r, ext, w, XS);
  __syncthreads();
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t in_plane = static_cast<size_t>(hin) * w;

  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    stage_rows(src + z * in_plane, w, YS, ext, XS, ext, E);
    __syncthreads();

    // 1. along the rows: R[row][col] centred on E[row][col + r]
    for (int i = tid; i < ext * kTile; i += kThreads) {
      const int row = i / kTile, col = i - row * kTile;
      const float* c = E + row * ext + col + r;
      float acc = __fmul_rn(W[r], c[0]);
      for (int k = 1; k <= r; ++k) {
        acc = __fadd_rn(acc, __fmul_rn(W[r - k], __fadd_rn(c[-k], c[k])));
      }
      R[i] = acc;
    }
    __syncthreads();

    // 2. down the columns: out[row][col] centred on R[row + r][col]
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int row = i / kTile, col = i - row * kTile;
      const int y = y0 + row, x = x0 + col;
      if (y >= h || x >= w) continue;
      const float* c = R + (row + r) * kTile + col;
      float acc = __fmul_rn(W[r], c[0]);
      for (int k = 1; k <= r; ++k) {
        acc = __fadd_rn(acc, __fmul_rn(W[r - k],
                                       __fadd_rn(c[-k * kTile], c[k * kTile])));
      }
      dst[z * plane + static_cast<size_t>(y) * w + x] = acc;
    }
    __syncthreads();  // E and R are refilled for the next frame
  }
}

template <bool kYPadded>
int run_tile(const float* src, int n, int h, int w, const GaussTaps& taps,
             int r, float* dst, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(gauss_smem_words(r)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gauss_tile_kernel<kYPadded>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the caller gets the code
    return static_cast<int>(err);
  }
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile,
                  n < 65535 ? n : 65535);
  gauss_tile_kernel<kYPadded><<<grid, kThreads, bytes, stream>>>(
      src, n, h, w, taps, r, dst);
  return static_cast<int>(cudaGetLastError());
}

template <bool kYPadded>
int run(const float* src, int n, int h, int w, const GaussTaps& taps, int r,
        float* dst, cudaStream_t stream) {
  if (r < 1 || r > kGaussMaxRadius || n < 1 || h < 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return r <= kRegMaxRadius
             ? run_reg<kYPadded>(src, n, h, w, taps, r, dst, stream)
             : run_tile<kYPadded>(src, n, h, w, taps, r, dst, stream);
}

}  // namespace

// src, dst: n frames of (h, w) float32, contiguous; taps.w[0 .. 2r].
extern "C" int tpuimg_gaussian(const float* src, int n, int h, int w,
                               GaussTaps taps, int r, float* dst,
                               cudaStream_t stream) {
  return run<false>(src, n, h, w, taps, r, dst, stream);
}

// src: n blocks of (h + 2r, w) float32 rows padded by r on each side; dst:
// n frames of (h, w); both contiguous.
extern "C" int tpuimg_gaussian_ypadded(const float* src, int n, int h, int w,
                                       GaussTaps taps, int r, float* dst,
                                       cudaStream_t stream) {
  return run<true>(src, n, h, w, taps, r, dst, stream);
}
