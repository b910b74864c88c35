// CLAHE per-tile 256-bin histograms.
//
// Replaces tpuimg/kernels/hist.py::hist_tiles_fused (:213), which on the TPU
// counts with nibble one-hot matmuls because the TPU has no atomics. Here the
// counting is what the reference's gCalcTileHistsUnroll does: shared-memory
// atomics, one 256-bin histogram per block, added into a zeroed global
// (ytiles * xtiles, 256) int32 buffer at the end. Counts are exact (the
// reference's early-return undercount, KNOWN_DIVERGENCES.md section 1, is
// not reproduced).
//
// The kernel reads the RAW (h, w) frame and maps each coordinate of the
// centred (ytiles*th, xtiles*tw) reflect-101 extension back into it with
// reflect101(); the extension is never materialised.
//
// Bound on this card: about one byte read and one shared-memory atomic per
// extension pixel (8.3 MB and 8.3 M atomics for a 4K frame); the atomics,
// not the bytes, set the time. To fill the card, each tile is split over
// blocks of kRowsPerBlock rows (blockIdx.y).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// rows of one tile that one block counts: a 4K 8x8 grid (270-row tiles)
// runs as 64 x 17 blocks instead of 64, enough to fill the card
constexpr int kRowsPerBlock = 16;

__global__ void __launch_bounds__(kThreads)
tile_hist_kernel(const uint8_t* __restrict__ img, int h, int w, int xtiles,
                 int th, int tw, int pad_top, int pad_left,
                 int* __restrict__ out) {
  __shared__ int hist[256];
  const int tile = blockIdx.x;
  const int ty = tile / xtiles, tx = tile - ty * xtiles;
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int nrows = min(kRowsPerBlock, th - r0);
  hist[threadIdx.x] = 0;  // kThreads == 256 bins
  __syncthreads();
  if (nrows > 0) {
    const int ey0 = ty * th + r0 - pad_top;  // extension row -> image row
    const int ex0 = tx * tw - pad_left;
    const int n = nrows * tw;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / tw;
      const int c = i - r * tw;
      const int y = reflect101(ey0 + r, h);
      const int x = reflect101(ex0 + c, w);
      atomicAdd(&hist[img[static_cast<size_t>(y) * w + x]], 1);
    }
  }
  __syncthreads();
  const int v = hist[threadIdx.x];
  if (v) atomicAdd(&out[tile * 256 + threadIdx.x], v);
}

}  // namespace

// out must be zeroed, (ytiles * xtiles, 256) int32.
extern "C" int tpuimg_tile_hist(const uint8_t* img, int h, int w, int ytiles,
                                int xtiles, int th, int tw, int pad_top,
                                int pad_left, int* out,
                                cudaStream_t stream) {
  const dim3 grid(ytiles * xtiles, (th + kRowsPerBlock - 1) / kRowsPerBlock);
  tile_hist_kernel<<<grid, kThreads, 0, stream>>>(
      img, h, w, xtiles, th, tw, pad_top, pad_left, out);
  return static_cast<int>(cudaGetLastError());
}
