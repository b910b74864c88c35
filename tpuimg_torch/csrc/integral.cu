// Integral image: the inclusive 2-D prefix sum of u8 frames into int32, with
// no leading zero row or column.
//
// Replaces tpuimg/kernels/scan2d.py::integral_pallas (:216). The TPU runs
// both scans as triangular matmuls over row bands and carries the column
// sums from one band to the next in VMEM, because its grid runs in order.
// Blocks here run in no order; this design computes the same numbers as the
// TPU's scan (scan2d.py:138-212), not its structure.
//
// Bound on this card: device memory. The function reads 1 byte and writes 4
// a pixel (41.5 MB at 4K, 0.0124 ms at 3.35 TB/s). This design reads the u8
// frame twice (the second time mostly from the 50 MB L2) and writes the
// int32 frame once; its only other traffic is one row of column sums a band,
// written and read back.
//
// A frame is cut into bands of R rows over its full width, and the integral
// is carried from band to band by column sums: with S_j[x] the sum of column
// x over band j and E_b[x] = S_0[x] + ... + S_(b-1)[x] (every row above band
// b), row y of band b is the row prefix of E_b[x] + (column x summed over the
// band's rows up to y). Three launches, in stream order:
// 1. band sums: a thread sums 4 columns of one band (one 4-byte load a row
//    where rows are 4-byte aligned), two 16-bit lanes to a word (R <= 256
//    keeps 255 R below 2^16), over up to 8 slices of a tall band's rows, and
//    writes S_j into the first row of band j + 1 of the output, which launch
//    3 overwrites last;
// 2. band scan: each column's S_j become E_(j+1) in place, a warp of columns
//    by 32 segments of bands;
// 3. band rows: a block takes a band and chunks of 4 columns a thread along
//    its rows, starting each column's running sum at E_b (read back from the
//    row it will overwrite). Rows are scanned 8 at a time between two
//    barriers, the next 8 rows' loads in flight meanwhile: each thread's
//    4-column prefix, a warp shuffle scan of the run totals, one warp per row
//    scanning the warp totals and carrying the chunk's total into the next
//    chunk; then 16-byte stores where rows are 16-byte aligned.
// Launches 2 and 3 may start while the one before drains (programmatic
// dependent launch). Bands are as many as one wave of band-rows blocks holds
// (the occupancy API), none shorter than 8 rows (their column sums cost 1/R
// of the output) nor longer than 256; a frame of one band runs launch 3
// alone. A scan fused into launch 1 (a lane per 4 columns and a warp per
// segment of bands, summing and scanning in one launch) measured slower at
// 4K and on 16 frames of 1080p: it has one block per 128 columns, 30 at 4K.
//
// Decoupled look-back (one pass, each band publishing its column sums and
// waiting on its predecessors) was the recommended alternative: with every
// band of a wave reaching its look-back together, each band would sum the
// column vectors of all bands above it, w words each (the square of the
// band count in traffic), where launch 2 reads each band's sums twice.
//
// Every sum is unsigned int and is stored as int32 bits: signed overflow is
// undefined in C++, and the result must wrap mod 2^32 as tpuimg's int32 adds
// do (an all-255 frame of 3000x3000, or of 8K, wraps). Modular sums may be
// taken in any order, so the result equals the plain version bit for bit.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kCols = 4;            // columns a thread owns: one u32 of u8
constexpr int kMaxThreads = 512;    // band-rows block: chunks of 2048 columns
constexpr int kGroup = 8;           // rows scanned between two barriers
constexpr int kMinBandRows = 8;
constexpr int kMaxBandRows = 256;   // 16-bit lanes of the band sums
constexpr int kSumThreads = 256;    // band-sums block
constexpr int kScanSegs = 32;       // warps of a band-scan block
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ unsigned warp_scan(unsigned v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned up = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// Programmatic dependent launch: launches 2 and 3 may start while the
// launch before them drains, and wait here, before their first read, until
// it has finished and its writes are visible; each launch lets the next one
// start once all its blocks run. (Without the launch attribute the wait
// returns at once: stream order already holds.)
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// the 4 bytes of a row at columns x .. x + 3 (0 past w); kVec: one 4-byte
// load (the frame's base and w are multiples of 4)
template <bool kVec>
__device__ __forceinline__ unsigned load4(const uint8_t* row, long long x,
                                          int w) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const unsigned*>(row + x));
  } else {
    unsigned v = 0;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      if (x + k < w) v |= static_cast<unsigned>(__ldg(row + x + k)) << (8 * k);
    }
    return v;
  }
}

// out[x .. x + 3] = v (the columns below w); kVec: one 16-byte store
template <bool kVec>
__device__ __forceinline__ void store4(unsigned* row, long long x, int w,
                                       const unsigned (&v)[kCols]) {
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(row + x) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      if (x + k < w) row[x + k] = v[k];
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void read4(const unsigned* row, long long x, int w,
                                      unsigned (&v)[kCols]) {
  if constexpr (kVec) {
    const uint4 q = *reinterpret_cast<const uint4*>(row + x);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k) v[k] = x + k < w ? row[x + k] : 0u;
  }
}

// Launch 1: S_j over a band's rows, for bands j < bands - 1 (the last band's
// sums feed nothing), into the first row of band j + 1 (which launch 3 reads
// back and overwrites). blockIdx.x: (frame, band); blockIdx.y: a stride over
// the block's columns. A block: 256 / slices column groups (a thread 4
// columns, a warp 128 contiguous bytes of a row) by `slices` slices of the
// band's rows (every slices-th row), whose sums the first slice adds.
template <bool kVec>
__global__ void __launch_bounds__(kSumThreads)
integral_band_sums_kernel(const uint8_t* __restrict__ img, int h, int w,
                          int rows, int bands, int slices,
                          unsigned* __restrict__ out) {
  __shared__ uint2 part[kSumThreads];
  let_next_start();
  const int groups = kSumThreads / slices;
  const int g = threadIdx.x % groups, slice = threadIdx.x / groups;
  const unsigned fb = blockIdx.x;
  const unsigned f = fb / (bands - 1), b = fb - f * (bands - 1);
  const size_t top = static_cast<size_t>(f) * h + static_cast<size_t>(b) * rows;
  const uint8_t* src = img + top * w;
  unsigned* dst = out + (top + rows) * w;
  const long long cols = static_cast<long long>(kCols) * groups;
  for (long long c0 = blockIdx.y * cols; c0 < w; c0 += gridDim.y * cols) {
    const long long x = c0 + kCols * g;
    unsigned even = 0, odd = 0;  // columns x, x + 2 and x + 1, x + 3
    if (x < w) {
#pragma unroll 8
      for (int y = slice; y < rows; y += slices) {
        const unsigned v = load4<kVec>(src + static_cast<size_t>(y) * w, x,
                                       w);
        even += v & 0x00ff00ffu;
        odd += (v >> 8) & 0x00ff00ffu;
      }
    }
    if (slices > 1) {
      part[threadIdx.x] = make_uint2(even, odd);
      __syncthreads();
      if (slice == 0) {
        for (int k = 1; k < slices; ++k) {
          even += part[k * groups + g].x;
          odd += part[k * groups + g].y;
        }
      }
      __syncthreads();  // the next columns rewrite part
    }
    if (slice == 0 && x < w) {
      const unsigned s[kCols] = {even & 0xffffu, odd & 0xffffu, even >> 16,
                                 odd >> 16};
      store4<kVec>(dst, x, w, s);
    }
  }
}

// Launch 2: S_0 .. S_(bands - 2) of each column become their inclusive sums
// down the bands, E_1 .. E_(bands - 1), in place. A block: 32 columns (the
// lanes) by kScanSegs segments of bands (the warps): each warp sums its
// segment, warp k scans column k's segment sums, and each warp walks its
// segment again from its carry (its loads hit L1).
__global__ void __launch_bounds__(32 * kScanSegs)
integral_band_scan_kernel(int frames, int h, int w, int rows, int bands,
                          unsigned* __restrict__ out) {
  __shared__ unsigned seg_sums[kScanSegs][33];
  wait_for_previous();
  let_next_start();
  const int lane = threadIdx.x, warp = threadIdx.y;
  const long long x = static_cast<long long>(blockIdx.x) * 32 + lane;
  const int n = bands - 1;
  const int seg = (n + kScanSegs - 1) / kScanSegs;
  const int j0 = min(n, warp * seg), j1 = min(n, j0 + seg);
  const size_t step = static_cast<size_t>(rows) * w;  // band to band
  for (int f = blockIdx.y; f < frames; f += gridDim.y) {
    unsigned* col = out + (static_cast<size_t>(f) * h + rows) * w + x;
    unsigned s = 0;
    if (x < w) {
#pragma unroll 8
      for (int j = j0; j < j1; ++j) s += col[j * step];
    }
    seg_sums[warp][lane] = s;
    __syncthreads();
    {  // warp k: column k's segment sums, one segment a lane
      const unsigned own = seg_sums[lane][warp];
      seg_sums[lane][warp] = warp_scan(own, lane) - own;  // exclusive
    }
    __syncthreads();
    if (x < w) {
      unsigned carry = seg_sums[warp][lane];
#pragma unroll 8
      for (int j = j0; j < j1; ++j) {
        carry += col[j * step];
        col[j * step] = carry;
      }
    }
    __syncthreads();  // the next frame rewrites seg_sums
  }
}

// Launch 3: the rows of one band (blockIdx.x: (frame, band)).
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
integral_band_rows_kernel(const uint8_t* __restrict__ img, int h, int w,
                          int rows, int bands, unsigned* __restrict__ out) {
  __shared__ unsigned warp_sums[kGroup][32];
  __shared__ unsigned row_carry[kMaxBandRows];  // the chunks left of this one
  const unsigned fb = blockIdx.x;
  const unsigned f = fb / bands, b = fb - f * bands;
  const int y0 = static_cast<int>(b) * rows;
  const int n = min(rows, h - y0);  // this band's rows
  const size_t top = static_cast<size_t>(f) * h + y0;
  const uint8_t* src = img + top * w;
  unsigned* dst = out + top * w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = tid; i < n; i += blockDim.x) row_carry[i] = 0;
  wait_for_previous();

  for (long long c0 = 0; c0 < w; c0 += static_cast<long long>(kCols) *
                                       blockDim.x) {
    const long long x = c0 + kCols * tid;
    // the bytes of kGroup rows from row g on, 0 past the band or the frame
    auto load_group = [&](int g, unsigned (&v)[kGroup]) {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        v[i] = g + i < n && x < w
                   ? load4<kVec>(src + static_cast<size_t>(g + i) * w, x, w)
                   : 0u;
      }
    };
    unsigned next[kGroup];
    load_group(0, next);
    unsigned acc[kCols] = {0, 0, 0, 0};  // column sums of every row so far
    if (b > 0 && x < w) read4<kVec>(dst, x, w, acc);  // E_b
    for (int g0 = 0; g0 < n; g0 += kGroup) {
      unsigned v[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) v[i] = next[i];
      load_group(g0 + kGroup, next);  // in flight while this group scans
      unsigned pre[kGroup][kCols];  // the thread's inclusive row prefixes
      unsigned before[kGroup];      // the run totals of lower lanes
      __syncwarp();  // lanes still reading warp_sums of the last group
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        unsigned run = 0;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          acc[k] += (v[i] >> (8 * k)) & 0xffu;
          run += acc[k];
          pre[i][k] = run;
        }
        const unsigned incl = warp_scan(run, lane);
        before[i] = incl - run;
        if (lane == 31) warp_sums[i][warp] = incl;
      }
      __syncthreads();
      // a warp a row: the warp totals' exclusive scan plus the row's carry
      for (int i = warp; i < kGroup && g0 + i < n; i += nwarps) {
        const unsigned s = lane < nwarps ? warp_sums[i][lane] : 0u;
        const unsigned incl = warp_scan(s, lane);
        const unsigned total = __shfl_sync(0xffffffffu, incl, 31);
        const unsigned carry = row_carry[g0 + i];
        warp_sums[i][lane] = incl - s + carry;
        __syncwarp();
        if (lane == 0) row_carry[g0 + i] = carry + total;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (g0 + i < n && x < w) {
          const unsigned off = before[i] + warp_sums[i][warp];
          unsigned o[kCols];
#pragma unroll
          for (int k = 0; k < kCols; ++k) o[k] = pre[i][k] + off;
          store4<kVec>(dst + static_cast<size_t>(g0 + i) * w, x, w, o);
        }
      }
    }
  }
}

// The band plan: rows a band, bands a frame, threads a band-rows block.
struct Plan {
  int rows, bands, threads;
};

template <bool kVec>
cudaError_t plan_bands(int frames, int h, int w, Plan* p) {
  const long long groups = (static_cast<long long>(w) + kCols - 1) / kCols;
  p->threads = static_cast<int>(
      std::min<long long>(kMaxThreads, (groups + 31) / 32 * 32));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, integral_band_rows_kernel<kVec>, p->threads, 0);
  }
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(sms) * per_sm;
  long long bands = std::min(slots / frames,
                             (h + kMinBandRows - 1LL) / kMinBandRows);
  bands = std::max({1LL, bands, (h + kMaxBandRows - 1LL) / kMaxBandRows});
  p->rows = static_cast<int>((h + bands - 1) / bands);
  p->bands = (h + p->rows - 1) / p->rows;
  return cudaSuccess;
}

// a launch that may begin before the one ahead of it on the stream ends
// (programmatic dependent launch); the kernel waits for it before reading
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, dim3 block,
                         cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <bool kVec>
int launch_all(const uint8_t* img, int frames, int h, int w, unsigned* out,
               cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan_bands<kVec>(frames, h, w, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.bands > 1) {
    int slices = 1;
    while (slices < 8 && 32 * slices <= p.rows) slices *= 2;
    const long long cols = static_cast<long long>(kCols) * kSumThreads /
                           slices;
    const dim3 sums(static_cast<unsigned>(frames) * (p.bands - 1),
                    static_cast<unsigned>(std::min<long long>(
                        kMaxGridY, (w + cols - 1) / cols)));
    integral_band_sums_kernel<kVec><<<sums, kSumThreads, 0, stream>>>(
        img, h, w, p.rows, p.bands, slices, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 scan(static_cast<unsigned>((w + 31LL) / 32),
                    static_cast<unsigned>(std::min(frames, kMaxGridY)));
    err = launch_after(integral_band_scan_kernel, scan, dim3(32, kScanSegs),
                       stream, frames, h, w, p.rows, p.bands, out);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = launch_after(integral_band_rows_kernel<kVec>,
                     dim3(static_cast<unsigned>(frames) * p.bands),
                     dim3(p.threads), stream, img, h, w, p.rows, p.bands, out);
  return static_cast<int>(err);
}

}  // namespace

// img: (frames, h, w) u8, contiguous, frames * h < 2^31; out: (frames, h, w)
// int32.
extern "C" int tpuimg_integral(const uint8_t* img, int frames, int h, int w,
                               int* out, cudaStream_t stream) {
  if (frames < 1 || h < 1 || w < 1 ||
      static_cast<long long>(frames) * h >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned* sums = reinterpret_cast<unsigned*>(out);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? launch_all<true>(img, frames, h, w, sums, stream)
             : launch_all<false>(img, frames, h, w, sums, stream);
}
