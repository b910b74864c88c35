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
// rows are an identity table (common.cuh::clamped_table) instead of the
// reflected one; x is still reflect-101 in the kernel. Everything else is
// the one kernel body. tpuimg's column strips for w > 4096 are a TPU lane
// limit; this kernel takes any width.
//
// Design on this card: one block per 32x32 output tile of one frame
// (gridDim.z runs over the frames). It stages the tile's (32 + 2r)^2 input
// extent in shared memory through the iterated reflect-101 index, so the
// frame is never padded in device memory and a frame smaller than the halo
// is exact; the extent's reflected rows and columns are two small index
// tables, computed once per block. Row pass (along x) over the extent's
// rows, then column pass, both in the symmetric form
// w[r]*c + sum_i w[r-i]*(left_i + right_i) in the plain version's order;
// every multiply and add is rounded on its own (__fmul_rn/__fadd_rn), so
// nvcc cannot contract them into FMAs and the result equals the plain
// PyTorch version bit for bit.
// Bound: shared-memory loads, about 2(2r + 1) per output pixel plus the
// staging, against 8 bytes of device memory per pixel (the halo re-read hits
// L2). Shared memory is (32 + 2r)^2 + 32(32 + 2r) + 2r + 1 floats and
// 2(32 + 2r) ints; at r = 96 that is 231,940 bytes, the largest radius under
// the 227 KB (232,448 bytes) a block may use. Larger radii are refused
// (kGaussMaxRadius).
#include "common.cuh"

constexpr int kGaussMaxRadius = 96;
constexpr int kGaussMaxTaps = 2 * kGaussMaxRadius + 1;

// the taps travel by value in the launch's parameter space (772 bytes):
// no device buffer, no host-to-device copy before the launch
struct GaussTaps {
  float w[kGaussMaxTaps];
};

namespace {

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
gaussian_kernel(const float* __restrict__ src, int n, int h, int w,
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
int run(const float* src, int n, int h, int w, const GaussTaps& taps, int r,
        float* dst, cudaStream_t stream) {
  if (r < 1 || r > kGaussMaxRadius || n < 1 || h < 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = static_cast<size_t>(gauss_smem_words(r)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gaussian_kernel<kYPadded>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the caller gets the code
    return static_cast<int>(err);
  }
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile,
                  n < 65535 ? n : 65535);
  gaussian_kernel<kYPadded><<<grid, kThreads, bytes, stream>>>(
      src, n, h, w, taps, r, dst);
  return static_cast<int>(cudaGetLastError());
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
