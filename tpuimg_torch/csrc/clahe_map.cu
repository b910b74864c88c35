// CLAHE bilinear 4-LUT mapping of a whole frame.
//
// Replaces tpuimg/kernels/lut.py::clahe_map_full (:341, kernel factory :273)
// and covers what clahe_band_map does for tiny tiles: the TPU forms resolve
// tile indices per static x-run and 32-row block because the TPU has no cheap
// gather; here each thread owns one pixel, computes its own tile indices and
// reads its four table entries, so any tile grid works. The per-pixel blend
// is common.cuh::clahe_blend, which the fused enhance tail
// (enhance_tail_clahe.cu) shares.
//
// It also replaces tpuimg/kernels/lut.py::clahe_band_map (:502,
// pallas_call :518): the blend of a band of rows that starts at global row
// y0 of a frame, with that frame's tables and geometry, is the same kernel
// with y + y0 handed to clahe_blend (the whole frame is the band at y0 = 0).
// It serves tpuimg's one-ty1 y-run band and a row shard of clahe_sharded
// (parallel/sharding.py) alike; tpuimg's (n_xruns, 4, 256) per-band table
// bank is a TPU layout (no cheap gather) and is not built.
//
// Bound on this card: memory traffic, 1 byte in and 4 bytes (f32) or 1 byte
// (u8) out per pixel; the (T, 256) float tables (64 KB for 8x8) stay in
// L1/L2, so the four table reads per pixel are cache hits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kOutF32>
__global__ void __launch_bounds__(kThreads)
clahe_map_kernel(const uint8_t* __restrict__ img, int h, int w, int y0,
                 const ClaheGeom g, void* __restrict__ out) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const size_t p = static_cast<size_t>(y) * w + x;
  const float o = clahe_blend(g, img[p], y + y0, x);
  if constexpr (kOutF32) {
    static_cast<float*>(out)[p] = o;
  } else {
    // float -> uchar assignment of the reference: truncate, clamp
    static_cast<uint8_t*>(out)[p] =
        static_cast<uint8_t>(fminf(fmaxf(truncf(o), 0.0f), 255.0f));
  }
}

}  // namespace

// img: the (h, w) rows [y0, y0 + h) of a frame whose tile grid the other
// arguments describe; out is (h, w) float32 when out_f32, else uint8.
extern "C" int tpuimg_clahe_map(const uint8_t* img, int h, int w, int y0,
                                const float* tables, int ytiles, int xtiles,
                                int th, int pad_top, int pad_left,
                                float inv_tw, int out_f32, void* out,
                                cudaStream_t stream) {
  if (h < 1 || w < 1 || y0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((w + kThreads - 1) / kThreads, h);
  const ClaheGeom g{tables, ytiles, xtiles, static_cast<float>(th),
                    static_cast<float>(pad_top), static_cast<float>(pad_left),
                    inv_tw};
  if (out_f32) {
    clahe_map_kernel<true><<<grid, kThreads, 0, stream>>>(img, h, w, y0, g,
                                                          out);
  } else {
    clahe_map_kernel<false><<<grid, kThreads, 0, stream>>>(img, h, w, y0, g,
                                                           out);
  }
  return static_cast<int>(cudaGetLastError());
}
