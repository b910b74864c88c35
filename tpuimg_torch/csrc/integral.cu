// Integral image: the inclusive 2-D prefix sum of u8 frames into int32, with
// no leading zero row or column.
//
// Replaces tpuimg/kernels/scan2d.py::integral_pallas (:216). The TPU runs
// both scans as triangular matmuls over row bands and carries the column
// sums from one band to the next in VMEM, because its grid runs in order.
// Blocks here run in no order, so the scan is two kernels, one launch each:
// 1. rows: one block per row of every frame, over chunks of up to 1024
//    pixels: a warp-shuffle scan in each warp, a scan of the warp totals, and
//    a running carry from chunk to chunk;
// 2. columns, in place on the row sums: a block owns 32 columns of one
//    frame; each of its 32 warps sums one segment of rows, the 32 segment
//    sums of each column are scanned, and each warp walks its segment again,
//    adding the carry.
// It computes the same numbers as the TPU's scan (scan2d.py:138-212), not
// its structure. Every sum is unsigned int and is stored as int32 bits:
// signed overflow is undefined in C++, and the result must wrap mod 2^32 as
// tpuimg's int32 adds do (an all-255 frame of 3000x3000, or of 8K, wraps).
//
// Bound on this card: device memory. The row pass reads 1 byte and writes 4
// per pixel; the column pass reads the 4 twice (the second time mostly from
// L2) and writes them once: about 108 MB at 4K.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxRowThreads = 1024;
constexpr int kCols = 32;  // columns of a column-pass block: one warp wide
constexpr int kSegs = 32;  // row segments of a column-pass block: its warps
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ unsigned warp_scan(unsigned v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned up = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

__global__ void __launch_bounds__(kMaxRowThreads)
integral_rows_kernel(const uint8_t* __restrict__ img, int w,
                     unsigned* __restrict__ out) {
  __shared__ unsigned warp_sums[32];
  const long long row = blockIdx.x;  // over frames * h rows
  const uint8_t* src = img + row * w;
  unsigned* dst = out + row * w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned carry = 0;
  for (int c0 = 0; c0 < w; c0 += blockDim.x) {
    const int x = c0 + threadIdx.x;
    const unsigned v = warp_scan(x < w ? src[x] : 0u, lane);
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
      const unsigned s = lane < nwarps ? warp_sums[lane] : 0u;
      warp_sums[lane] = warp_scan(s, lane);
    }
    __syncthreads();
    const unsigned before = warp == 0 ? 0u : warp_sums[warp - 1];
    if (x < w) dst[x] = carry + before + v;
    carry += warp_sums[nwarps - 1];
    __syncthreads();  // the next chunk rewrites warp_sums
  }
}

__global__ void __launch_bounds__(kCols * kSegs)
integral_cols_kernel(int frames, int h, int w, unsigned* __restrict__ out) {
  __shared__ unsigned seg_sums[kSegs][kCols + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * kCols + tx;
  const int seg = (h + kSegs - 1) / kSegs;
  const int y0 = min(h, ty * seg), y1 = min(h, y0 + seg);
  for (int f = blockIdx.y; f < frames; f += gridDim.y) {
    unsigned* col = out + static_cast<long long>(f) * h * w + x;
    unsigned s = 0;
    if (x < w) {
#pragma unroll 4
      for (int y = y0; y < y1; ++y) s += col[static_cast<long long>(y) * w];
    }
    seg_sums[ty][tx] = s;
    __syncthreads();
    // warp ty scans column ty's segment sums, one segment per lane
    const unsigned own = seg_sums[tx][ty];
    seg_sums[tx][ty] = warp_scan(own, tx) - own;  // exclusive
    __syncthreads();
    if (x < w) {
      unsigned carry = seg_sums[ty][tx];
#pragma unroll 4
      for (int y = y0; y < y1; ++y) {
        const long long at = static_cast<long long>(y) * w;
        carry += col[at];
        col[at] = carry;
      }
    }
    __syncthreads();  // the next frame rewrites seg_sums
  }
}

}  // namespace

// img: (frames, h, w) u8, contiguous, frames * h < 2^31; out: (frames, h, w)
// int32.
extern "C" int tpuimg_integral(const uint8_t* img, int frames, int h, int w,
                               int* out, cudaStream_t stream) {
  unsigned* sums = reinterpret_cast<unsigned*>(out);
  const int threads = std::min(kMaxRowThreads, (w + 31) / 32 * 32);
  integral_rows_kernel<<<static_cast<unsigned>(frames) * h, threads, 0,
                         stream>>>(img, w, sums);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kCols - 1) / kCols, std::min(frames, kMaxGridY));
  integral_cols_kernel<<<grid, dim3(kCols, kSegs), 0, stream>>>(frames, h, w,
                                                                sums);
  return static_cast<int>(cudaGetLastError());
}
