// CLAHE bilinear 4-LUT mapping of a band of rows of a frame.
//
// Replaces tpuimg/kernels/lut.py::clahe_map_full (:341, kernel factory :273)
// and tpuimg/kernels/lut.py::clahe_band_map (:502, pallas_call :518): the
// blend of the rows [y0, y0 + h) of a frame, with that frame's tables and
// geometry (the whole frame is the band at y0 = 0). It serves tpuimg's
// whole-frame map, its one-ty1 y-run band and a row shard of clahe_sharded
// (parallel/sharding.py) alike; tpuimg's per-band (n_xruns, 4, 256) table
// bank and static x-runs exist because the TPU has no cheap gather, and are
// not built. The blend is common.cuh's clahe_row, clahe_col and clahe_lerp,
// which clahe_blend (the fused enhance tail, enhance_tail_clahe.cu) also
// calls, so every value is the plain version's bit for bit.
//
// Bound on this card: memory traffic, 1 byte in and 4 bytes (f32) or 1 byte
// (u8) out per pixel, and the (T, 256) float tables once. The f32 output is
// the blend times a factor from the host (1, or 1/255 for the enhance
// pipeline, whose tail takes f = blend / 255), so that no elementwise pass
// over the frame follows the kernel. What held the
// first design (a thread a pixel) at 2.7-9x that bound: 1-byte loads and
// stores, the row's IEEE division repeated at every pixel, and four 4-byte
// gathers a pixel from the tables in L1/L2. This design:
// - A block of kWarps warps owns a span of 128 * kGroups columns and a run
//   of rows; each warp maps a row of the span at a time, its rows kWarps
//   apart. The block's rows cut into runs that share one tile-row pair
//   (ty1, ty2): the rows between two tile-row centres. For each run the
//   block stages the tables of the tile columns its span crosses into
//   shared memory, a pixel value's four corner entries (tile rows ty1 and
//   ty2 by tile columns tx1 and tx2 = tx1 + 1, clamped) side by side as one
//   float4, so that a pixel makes one 16-byte gather from shared memory
//   instead of four 4-byte ones from global memory.
// - A lane owns 4 * kGroups columns of the span: kGroups groups of 4
//   adjacent columns, 128 apart, so that each load (4 bytes a lane) and
//   each store (4 bytes, or 16 for f32) of a warp covers 128 contiguous
//   pixels. Their tile columns (as offsets into the staged tables) and
//   weights are computed once, in registers; a row's once per row; the
//   next row's loads are issued before this row's blend. A row whose input
//   or output is not 4-byte aligned at the lane's columns (widths such as
//   1917, or a band at an odd storage offset) and the frame's last partial
//   group take 1-byte loads and scalar stores with the same arithmetic.
// - Tile grids whose span tables pass kMaxStagedBytes (tiles narrower than
//   about 8 columns) run an instance that gathers the four entries from
//   global memory instead, as the first design did. The host sizes the grid
//   to one wave of blocks, each warp mapping kMinWarpRows rows at least.
#include <algorithm>
#include <cmath>

#include "common.cuh"
#include "enhance_plan.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroups = 2;            // groups of 4 columns a lane takes
constexpr int kCols = 4 * kGroups;    // columns a lane takes
constexpr int kSpan = 32 * kCols;     // columns a block takes
constexpr int kMaxStagedBytes = 96 * 1024;
// rows a warp maps at least, so that a block's staging and its columns'
// coordinates are paid over that many rows
constexpr int kMinWarpRows = 2;

// the tile columns tx1 takes over `cols` columns, a bound for a span's
// shared memory: their f32 coordinates change by at most (cols - 1) / tw,
// one more for rounding
int tile_cols(int cols, int xtiles, float inv_tw) {
  const double n = std::floor(static_cast<double>(cols) * inv_tw) + 2.0;
  return static_cast<int>(std::min(n, static_cast<double>(xtiles)));
}

// float -> uchar assignment of the reference: truncate, clamp to [0, 255]
// (the conversion truncates and clamps below at 0, NaN to 0)
__device__ __forceinline__ unsigned to_u8(float o) {
  return min(__float2uint_rz(o), 255u);
}

// kStaged: the tables of the span in shared memory; otherwise gathered
// from global memory (common.cuh::clahe_blend's reads)
// kOutF32: out is the float32 blend times scale (__fmul_rn: the factor 1
// keeps the blend's bits), else the u8 blend
template <bool kOutF32, bool kStaged>
__global__ void __launch_bounds__(kThreads)
clahe_map_kernel(const uint8_t* __restrict__ img, int h, int w, int y0,
                 const ClaheGeom g, float scale, int rows_per_block,
                 void* __restrict__ out) {
  extern __shared__ __align__(16) float4 tab[];  // [tile column][256]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kSpan;  // the span's first column
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(h, r0 + rows_per_block);
  // column j of the lane: c0 + 128 * (j / 4) + 4 * lane + j % 4
  auto column = [&](int j) { return c0 + 128 * (j / 4) + 4 * lane + j % 4; };
  // the span's first tile column; the lane's columns as offsets into the
  // staged tables (or tile columns) and their weights toward tx2
  const int tc0 = kStaged ? clahe_col(g, c0).t1 : 0;
  int off[kCols];
  float xa[kCols], xa1[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const ClaheAxis ax = clahe_col(g, min(column(j), w - 1));
    off[j] = kStaged ? (ax.t1 - tc0) * 256 : ax.t1;
    xa[j] = ax.a;
    xa1[j] = ax.a1;
  }
  const int tcols = clahe_col(g, min(c0 + kSpan, w) - 1).t1 - tc0 + 1;
  int staged = -1;  // the tile row whose pair the tables hold
  for (int a = r0; a < r1;) {
    // the run of rows from a that share a's tile-row pair (ty1 is
    // non-decreasing down the frame), at most kThreads of them
    const int ty1 = clahe_row(g, y0 + a).t1;
    const int rr = a + threadIdx.x;
    const int b =
        a + __syncthreads_count(rr < r1 && clahe_row(g, y0 + rr).t1 == ty1);
    const int ty2 = min(ty1 + 1, g.ytiles - 1);
    if (kStaged && ty1 != staged) {  // the barrier above ends every read
      const float* t1 = g.tables + ty1 * g.xtiles * 256;
      const float* t2 = g.tables + ty2 * g.xtiles * 256;
      for (int i = threadIdx.x; i < tcols * 256; i += kThreads) {
        const int tx1 = tc0 + (i >> 8), v = i & 255;
        const int a1 = tx1 * 256 + v;
        const int a2 = min(tx1 + 1, g.xtiles - 1) * 256 + v;
        tab[i] = make_float4(__ldg(t1 + a1), __ldg(t1 + a2), __ldg(t2 + a1),
                             __ldg(t2 + a2));
      }
      __syncthreads();
      staged = ty1;
    }
    // group k of a row comes in one 4-byte load where the row's input is
    // 4-byte aligned there and its output 4-byte (u8) or 16-byte (f32)
    // aligned
    auto aligned = [&](int y) {
      const size_t p = static_cast<size_t>(y) * w + column(0);
      const uintptr_t o = reinterpret_cast<uintptr_t>(out) +
                          p * (kOutF32 ? sizeof(float) : 1);
      return (reinterpret_cast<uintptr_t>(img + p) & 3) == 0 &&
             (o & (kOutF32 ? 15 : 3)) == 0;
    };
    auto load = [&](int y, unsigned* q) {
      const uint8_t* src = img + static_cast<size_t>(y) * w;
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        const int x = column(4 * k);
        q[k] = x + 4 <= w ? __ldg(reinterpret_cast<const unsigned*>(src + x))
                          : 0u;
      }
    };
    int y = a + warp;
    bool vec_next = y < b && aligned(y);
    unsigned q_next[kGroups];
    if (vec_next) load(y, q_next);
    for (; y < b; y += kWarps) {
      const bool vec = vec_next;
      unsigned q[kGroups];
#pragma unroll
      for (int k = 0; k < kGroups; ++k) q[k] = q_next[k];
      if (y + kWarps < b) {
        vec_next = aligned(y + kWarps);
        if (vec_next) load(y + kWarps, q_next);
      }
      const ClaheAxis ry = clahe_row(g, y0 + y);
      const size_t row = static_cast<size_t>(y) * w;
      auto blend = [&](int j, unsigned v) {
        if constexpr (kStaged) {
          const float4 t = tab[off[j] + v];
          return clahe_lerp(t.x, t.y, t.z, t.w, xa[j], xa1[j], ry.a, ry.a1);
        } else {
          const int tx2 = min(off[j] + 1, g.xtiles - 1);
          const float* t1 = g.tables + ry.t1 * g.xtiles * 256 + v;
          const float* t2 = g.tables + ry.t2 * g.xtiles * 256 + v;
          return clahe_lerp(__ldg(t1 + off[j] * 256), __ldg(t1 + tx2 * 256),
                            __ldg(t2 + off[j] * 256), __ldg(t2 + tx2 * 256),
                            xa[j], xa1[j], ry.a, ry.a1);
        }
      };
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        const int x = column(4 * k);
        if (vec && x + 4 <= w) {
          float o[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            o[jj] = blend(4 * k + jj, (q[k] >> (8 * jj)) & 0xFFu);
          }
          if constexpr (kOutF32) {
            *reinterpret_cast<float4*>(static_cast<float*>(out) + row + x) =
                make_float4(__fmul_rn(o[0], scale), __fmul_rn(o[1], scale),
                            __fmul_rn(o[2], scale), __fmul_rn(o[3], scale));
          } else {
            *reinterpret_cast<unsigned*>(static_cast<uint8_t*>(out) + row +
                                         x) =
                to_u8(o[0]) | to_u8(o[1]) << 8 | to_u8(o[2]) << 16 |
                to_u8(o[3]) << 24;
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (x + jj < w) {
              const float o = blend(4 * k + jj, __ldg(img + row + x + jj));
              if constexpr (kOutF32) {
                static_cast<float*>(out)[row + x + jj] = __fmul_rn(o, scale);
              } else {
                static_cast<uint8_t*>(out)[row + x + jj] =
                    static_cast<uint8_t>(to_u8(o));
              }
            }
          }
        }
      }
    }
    a = b;
  }
}

// The configure half of a launch of clahe_map_kernel<kOutF32, kStaged> with
// `bytes` of shared memory: one wave, the spans of a row times as many runs
// of rows as fill it, each run at least kMinWarpRows rows a warp.
template <bool kOutF32, bool kStaged>
int configure_map(int h, int w, size_t bytes, Launch* c) {
  auto kernel = clahe_map_kernel<kOutF32, kStaged>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  smem_ceiling_set();
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long spans = (w + kSpan - 1) / kSpan;
  const long long slots = std::max(1LL, static_cast<long long>(sms) * per_sm);
  const long long runs = std::max(1LL, slots / spans);
  const int rows = static_cast<int>(
      std::max<long long>((h + runs - 1) / runs, kMinWarpRows * kWarps));
  *c = {reinterpret_cast<const void*>(kernel),
        dim3(static_cast<unsigned>(spans),
             static_cast<unsigned>((h + rows - 1) / rows)),
        rows, static_cast<int>(bytes), 2 * kOutF32 + kStaged};
  return 0;
}

// The launch half: the configured grid, no CUDA query.
template <bool kOutF32, bool kStaged>
int launch_map(const Launch& c, const uint8_t* img, int h, int w, int y0,
               const ClaheGeom& g, float scale, void* out,
               cudaStream_t stream) {
  clahe_map_kernel<kOutF32, kStaged><<<c.grid, kThreads, c.bytes, stream>>>(
      img, h, w, y0, g, scale, c.rows, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The mapping's launch on (h, w) rows of a frame tiled xtiles across with
// the host's f32 1/tw: the staged instance where its span's tables fit
// kMaxStagedBytes, the instance that gathers from device memory past it.
int clahe_map_configure(int h, int w, int xtiles, float inv_tw, bool out_f32,
                        Launch* c) {
  if (h < 1 || w < 1 || xtiles < 1 || !(inv_tw > 0.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes =
      static_cast<size_t>(tile_cols(std::min(kSpan, w), xtiles, inv_tw)) *
      256 * sizeof(float4);
  if (bytes <= kMaxStagedBytes) {
    return out_f32 ? configure_map<true, true>(h, w, bytes, c)
                   : configure_map<false, true>(h, w, bytes, c);
  }
  return out_f32 ? configure_map<true, false>(h, w, 0, c)
                 : configure_map<false, false>(h, w, 0, c);
}

int clahe_map_launch(const Launch& c, const uint8_t* img, int h, int w,
                     int y0, const ClaheGeom& g, float scale, void* out,
                     cudaStream_t stream) {
  switch (c.route) {  // 2 * kOutF32 + kStaged (configure_map)
    case 3:
      return launch_map<true, true>(c, img, h, w, y0, g, scale, out, stream);
    case 2:
      return launch_map<true, false>(c, img, h, w, y0, g, scale, out, stream);
    case 1:
      return launch_map<false, true>(c, img, h, w, y0, g, scale, out, stream);
    default:
      return launch_map<false, false>(c, img, h, w, y0, g, scale, out,
                                      stream);
  }
}

// img: the (h, w) rows [y0, y0 + h) of a frame whose tile grid the other
// arguments describe; out is (h, w) float32 when out_f32, the blend times
// scale (1 for the raw blend, the f32 value of 1/255 for the enhance
// pipeline's f), else uint8 (scale unused).
extern "C" int tpuimg_clahe_map(const uint8_t* img, int h, int w, int y0,
                                const float* tables, int ytiles, int xtiles,
                                int th, int pad_top, int pad_left,
                                float inv_tw, int out_f32, float scale,
                                void* out, cudaStream_t stream) {
  if (h < 1 || w < 1 || y0 < 0 || ytiles < 1 || xtiles < 1 ||
      !(inv_tw > 0.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch c;
  const int err = clahe_map_configure(h, w, xtiles, inv_tw, out_f32 != 0, &c);
  if (err != 0) return err;
  const ClaheGeom g{tables, ytiles, xtiles, static_cast<float>(th),
                    static_cast<float>(pad_top), static_cast<float>(pad_left),
                    inv_tw};
  return clahe_map_launch(c, img, h, w, y0, g, scale, out, stream);
}
