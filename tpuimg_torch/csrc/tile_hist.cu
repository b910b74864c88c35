// CLAHE per-tile 256-bin histograms.
//
// Replaces tpuimg/kernels/hist.py::hist_tiles_fused (:213), which on the TPU
// counts with nibble one-hot matmuls because the TPU has no atomics. Here the
// counting is what the reference's gCalcTileHistsUnroll does, shared-memory
// atomics, and counts are exact (the reference's early-return undercount,
// KNOWN_DIVERGENCES.md section 1, is not reproduced).
//
// The kernel reads the RAW (h, w) frame; the centred (ytiles*th, xtiles*tw)
// reflect-101 extension is never materialised.
//
// Bound on this card: one byte read a pixel of the extension (8.3 MB for a
// 4K frame) and 1 KB written a tile. The first design (one shared histogram
// a block of 16 rows, every pixel mapped through two reflect101 calls and a
// division, added into an output that a memset zeroed first) took two
// launches at 4K: 0.0184 ms of device time and a 0.0009 ms memset by the
// profiler. This design:
// - Counts runs, not reflected pixels. An extension row of a tile is one
//   frame row (reflect101 once a row), and its tw columns are at most three
//   contiguous runs of that row: the mirrored left part (first tile column),
//   the interior, the mirrored right part (last tile column). A histogram
//   ignores order, so a mirrored run is counted forwards (tile_runs;
//   kernels/hist.py::tile_runs mirrors it). A block's rows of a run are a
//   flat list of aligned 16-byte blocks, a 16-byte load each, the bytes
//   outside the run skipped; a thread loads kAhead blocks before it counts
//   any. (A warp a row, its lanes along the row, waited on one load a row:
//   0.0090 ms at 4K by the profiler.)
// - One launch, no memset, no workspace: the blocks that count one tile form
//   a thread-block cluster of 1 to 8 (kernels/hist.py::tile_hist_plan sizes
//   it, and the rows each block counts, to fill the card). Each block counts
//   its rows into per-warp sub-histograms in shared memory (warps never wait
//   on each other's bins), sums them and stores the sums in its slot of
//   rank 0's shared memory (distributed shared memory); after one
//   cluster.sync(), rank 0 adds the slots and writes the tile's 256 bins.
//   (Two barriers, each block summing a slice of the bins from its peers'
//   memory after the first and waiting at the second until its peers had
//   read its own: 0.0075 ms at 4K by the profiler against 0.0069; with no
//   exchange at all, 0.0058.)
//
// CLAHE's tables (tpuimg_tile_tables): the same launch ends, in the block
// that holds a tile's 256 sums (rank 0, bin b in thread b), with the clip
// and redistribution of gClipLimit and the scaled cdf of gCreateTable, all
// in integers up to one f32 multiply, so the tables are
// ops/histogram.py::_clahe_tables bit for bit. Each step is a reduction or
// a scan over one block's 256 values (warp shuffles, then the 8 warp
// totals through shared memory). At 4K over 8x8 tiles the launch takes
// 0.0086 ms of device time by the profiler against the histograms' 0.0080
// (0.0212 against 0.0177 over 64x64 tiles); building the tables with
// PyTorch ops after the histogram launch took 29 kernels and 0.0597 ms of
// device time, and 0.25-0.42 ms of host time a call (NVIDIA H100 80GB
// HBM3, 700 W).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // == 256 bins: one bin a thread to sum
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kAhead = 2;  // 16-byte loads a thread has in flight

// The frame columns of tile column tx, as three (start, length) runs in
// fixed slots: the mirror of the extension's columns before 0, those inside
// the frame, the mirror of those past w - 1 (length 0 where absent). Valid
// while the pads are below w, as reflect101 is.
__device__ __forceinline__ void tile_runs(int w, int tw, int pad_left,
                                          int tx, int2 runs[3]) {
  const int a = tx * tw - pad_left, b = a + tw;  // extension columns [a, b)
  const int e = min(b, 0);                      // [a, e) -> x = -ex
  runs[0] = make_int2(1 - e, max(e - a, 0));
  const int i0 = max(a, 0), i1 = min(b, w);     // [i0, i1) -> x = ex
  runs[1] = make_int2(i0, max(i1 - i0, 0));
  const int s = max(a, w);                      // [s, b) -> x = 2w - 2 - ex
  runs[2] = make_int2(2 * w - 1 - b, max(b - s, 0));
}

// Counts columns [x0, x0 + len) of the frame rows of tile rows [r0, r1)
// (tile row ty). The work is a flat list of items (row, k): the k-th
// aligned 16-byte block that the row's run touches, pieces of them a row.
// A thread takes kAhead items at a time, loading all before counting any,
// so that several loads are in flight; the bytes of a block outside the
// run (at its ends) are skipped. Every load holds a byte of the run, so no
// load leaves the frame's 16-byte granules.
__device__ __forceinline__ void count_run(const uint8_t* img, int h, int w,
                                          int ty, int th, int pad_top,
                                          int r0, int r1, int x0, int len,
                                          int* hist) {
  // blocks a row's run touches: exactly, where every row starts at one
  // offset from a 16-byte boundary; else at most
  const int s0 = static_cast<int>(
      (reinterpret_cast<uintptr_t>(img) + x0) & 15);
  const int pieces =
      (w & 15) == 0 ? ((s0 + len - 1) >> 4) + 1 : ((len + 14) >> 4) + 1;
  const int items = (r1 - r0) * pieces;
  // the thread's first item and the step of kThreads items, as (row, k)
  int r = threadIdx.x / pieces, k = threadIdx.x - r * pieces;
  const int dr = kThreads / pieces, dk = kThreads - dr * pieces;
  for (int i0 = 0; i0 < items; i0 += kThreads * kAhead) {
    uint4 v[kAhead];
    int lo[kAhead], hi[kAhead];  // the run's bytes in block u
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      lo[u] = 16, hi[u] = 0;
      if (i0 + u * kThreads + static_cast<int>(threadIdx.x) < items) {
        const int y = reflect101(ty * th + r0 + r - pad_top, h);
        const uintptr_t a = reinterpret_cast<uintptr_t>(img) +
                            static_cast<size_t>(y) * w + x0;
        const uintptr_t blk = (a & ~static_cast<uintptr_t>(15)) + 16 * k;
        lo[u] = static_cast<int>(max(static_cast<intptr_t>(a - blk),
                                     static_cast<intptr_t>(0)));
        hi[u] = static_cast<int>(min(static_cast<intptr_t>(a + len - blk),
                                     static_cast<intptr_t>(16)));
        if (hi[u] > lo[u]) v[u] = __ldg(reinterpret_cast<const uint4*>(blk));
      }
      k += dk, r += dr;
      if (k >= pieces) k -= pieces, ++r;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (lo[u] == 0 && hi[u] == 16) {
        count_word(v[u].x, hist);
        count_word(v[u].y, hist);
        count_word(v[u].z, hist);
        count_word(v[u].w, hist);
      } else if (hi[u] > lo[u]) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (j >= lo[u] && j < hi[u]) atomicAdd(&hist[byte_of(v[u], j)], 1);
        }
      }
    }
  }
}

// CLAHE's table of one tile, thread b holding bin b's count v: every bin
// clipped at limit; the excess over it, steal, given back steal >> 8 to
// every bin and the residual r = steal & 255 one count each to bins
// (i << 8) / r, i < r, counted in closed form (bin b gets those i with
// ceil(b r / 256) <= i <= floor(((b + 1) r - 1) / 256)); then the inclusive
// cdf times fr (ops/histogram.py::_clip_redistribute, _clahe_tables). red
// holds 2 * kWarps ints of shared memory.
__device__ __forceinline__ void clahe_table(int v, int limit, float fr,
                                            int* red, float* dst) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int excess = __reduce_add_sync(0xffffffffu, max(v - limit, 0));
  if (lane == 0) red[warp] = excess;
  __syncthreads();
  int steal = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) steal += red[k];
  const int residual = steal & 255;
  int c = min(v, limit) + (steal >> 8);
  if (residual > 0) {
    const int lo = (tid * residual + 255) >> 8;
    const int hi = ((tid + 1) * residual - 1) >> 8;
    c += max(hi - lo + 1, 0);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, c, d);
    if (lane >= d) c += up;
  }
  if (lane == 31) red[kWarps + warp] = c;
  __syncthreads();
  for (int k = 0; k < warp; ++k) c += red[kWarps + k];
  dst[tid] = __fmul_rn(__int2float_rn(c), fr);
}

// Block rank r of tile t's cluster counts the tile's rows
// [r * rows, min(th, (r + 1) * rows)) (none past th) and stores its sums in
// slot r of rank 0's shared memory; rank 0 adds the slots and writes the
// tile's histogram to hists[t] or, kTables, its CLAHE table to tables[t].
template <bool kTables>
__global__ void __launch_bounds__(kThreads)
tile_hist_kernel(const uint8_t* __restrict__ img, int h, int w, int xtiles,
                 int th, int tw, int pad_top, int pad_left, int rows,
                 int limit, float fr, int* __restrict__ hists,
                 float* __restrict__ tables) {
  __shared__ int sub[kWarps * 256];
  __shared__ int slots[kMaxCluster * 256];  // rank 0's: each block's sums
  __shared__ int red[2 * kWarps];  // the tables' warp totals
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / cs;
  const int ty = tile / xtiles, tx = tile - ty * xtiles;
  const int tid = threadIdx.x;
  // a peer's shared memory is written only once every block of the cluster
  // has started: all arrive here, and wait just before that write
  if (cs > 1) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }
  int* hist = sub + (tid >> 5) * 256;  // this warp's own: no block barrier
  for (int i = tid & 31; i < 256; i += 32) hist[i] = 0;
  __syncwarp();
  int2 runs[3];
  tile_runs(w, tw, pad_left, tx, runs);
  const int r0 = min(th, rank * rows), r1 = min(th, r0 + rows);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (runs[k].y > 0) {
      count_run(img, h, w, ty, th, pad_top, r0, r1, runs[k].x, runs[k].y,
                hist);
    }
  }
  __syncthreads();
  int v = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) v += sub[k * 256 + tid];
  if (cs > 1) {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    cluster.map_shared_rank(slots, 0)[rank * 256 + tid] = v;
    cluster.sync();  // every block's sums are in rank 0's slots
    // the others leave: no block reads a peer's memory now
    if (rank != 0) return;
    v = 0;
    for (int q = 0; q < cs; ++q) v += slots[q * 256 + tid];
  }
  const size_t at = static_cast<size_t>(tile) * 256;
  if constexpr (kTables) {
    clahe_table(v, limit, fr, red, tables + at);
  } else {
    hists[at + tid] = v;
  }
}

// One launch of tile_hist_kernel<kTables> over the tiles' clusters.
template <bool kTables>
int launch_tiles(const uint8_t* img, int h, int w, int ytiles, int xtiles,
                 int th, int tw, int pad_top, int pad_left, int cluster,
                 int rows, int limit, float fr, int* hists, float* tables,
                 cudaStream_t stream) {
  if (cluster < 1 || cluster > kMaxCluster || rows < 1 ||
      static_cast<long long>(cluster) * rows < th || ytiles < 1 ||
      xtiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ytiles * xtiles * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, tile_hist_kernel<kTables>, img, h, w, xtiles, th, tw, pad_top,
      pad_left, rows, limit, fr, hists, tables);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img: (h, w) u8, contiguous; the tile grid (ytiles, xtiles) of th x tw with
// pads (pad_top, pad_left), each pad below the frame's side; cluster (1-8)
// blocks a tile, each counting rows of it, cluster * rows >= th
// (kernels/hist.py::tile_hist_plan); out: (ytiles * xtiles, 256) int32,
// written whole.
extern "C" int tpuimg_tile_hist(const uint8_t* img, int h, int w, int ytiles,
                                int xtiles, int th, int tw, int pad_top,
                                int pad_left, int cluster, int rows,
                                int* out, cudaStream_t stream) {
  return launch_tiles<false>(img, h, w, ytiles, xtiles, th, tw, pad_top,
                             pad_left, cluster, rows, 0, 0.0f, out, nullptr,
                             stream);
}

// tpuimg_tile_hist's arguments, then CLAHE's clip limit in counts (0 to
// th * tw) and the table scale fr (the f32 of 255 / (th * tw)); out:
// (ytiles * xtiles, 256) float32, each tile's table, written whole.
extern "C" int tpuimg_tile_tables(const uint8_t* img, int h, int w,
                                  int ytiles, int xtiles, int th, int tw,
                                  int pad_top, int pad_left, int cluster,
                                  int rows, int limit, float fr, float* out,
                                  cudaStream_t stream) {
  if (limit < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tiles<true>(img, h, w, ytiles, xtiles, th, tw, pad_top,
                            pad_left, cluster, rows, limit, fr, nullptr, out,
                            stream);
}
