// The enhance pipeline's tail with the CLAHE mapping folded in:
// q = guided(I=f, p=gaussian(f, rg), r, eps) with f = clahe_blend(img) / 255,
// in one call (two launches) after the tile histograms (impl="fused1").
//
// Replaces tpuimg/kernels/boxsum.py::enhance_tail_clahe_pallas (:495; strip
// _enhance_tail_clahe_strip :416, blend kernels/lut.py::make_blend_band
// :389, math _tail_chain :295). The f32 blend never reaches device memory:
// the kernel reads the u8 frame (1 byte a pixel instead of the blend's 4)
// and the (ytiles*xtiles, 256) float tables that clahe_map.cu takes, and
// computes f on its strip's halo. The TPU form needs a 128-lane
// corner-table bank, per-band y-tile candidates and static x-runs because
// it has no cheap gather; here each staged pixel reads its own four table
// entries (L1/L2 hits), so any tile grid works.
//
// Border: the producer maps each coordinate through reflect-101 first, and
// the blend is evaluated at the mirrored pixel's own coordinates, so
// blend(pad(img)) equals pad(blend(img)) exactly (tpuimg/kernels/lut.py
// :396-401). f = __fmul_rn(blend, scale) with scale the f32 value of 1/255
// from the host, the one multiply the fused path does in PyTorch; the blend
// is common.cuh::clahe_blend and the tail enhance_tail.cuh::tail_kernel, the
// same code as clahe_map.cu and enhance_tail.cu, so impl="fused1" gives
// impl="fused"'s values. Bound: as enhance_tail.cu (bytes); the blend, an
// IEEE division and four cached table reads, runs once per pixel of walk
// 1's strips and their halo ((128 + 2 round4(r + rg)) / 128 columns and
// (seg + 2r + 2rg) / seg rows of the frame's: about 1.3 a pixel at 4K, r =
// 8, rg = 2) and once more per output pixel in walk 2. 4K, u8 q: 0.2744 ms
// on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6; bound 0.0050 ms).
#include "enhance_tail.cuh"

namespace {

struct ClaheSrc {
  using Raw = int;
  static constexpr bool kAsync = false;  // f is computed: raw, then value
  const uint8_t* img;
  int w;
  ClaheGeom g;
  float scale;
  __device__ __forceinline__ int raw(int y, int x) const {
    return __ldg(img + static_cast<size_t>(y) * w + x);
  }
  __device__ __forceinline__ float value(int v, int y, int x) const {
    return __fmul_rn(clahe_blend(g, v, y, x), scale);
  }
  bool aligned(int) const { return false; }  // nothing is copied
};

}  // namespace

// img: (h, w) u8; tables: (ytiles*xtiles, 256) float32; scratch, out_u8
// and out as tpuimg_enhance_tail's.
extern "C" int tpuimg_enhance_tail_clahe(const uint8_t* img, int h, int w,
                                         const float* tables, int ytiles,
                                         int xtiles, int th, int pad_top,
                                         int pad_left, float inv_tw,
                                         float scale, Taps taps, int rg,
                                         int r, float eps, float* scratch,
                                         int out_u8, void* out,
                                         cudaStream_t stream) {
  const ClaheGeom g{tables, ytiles, xtiles, static_cast<float>(th),
                    static_cast<float>(pad_top), static_cast<float>(pad_left),
                    inv_tw};
  const ClaheSrc src{img, w, g, scale};
  return out_u8 ? tail::launch(src, h, w, taps, rg, r, eps, scratch,
                               static_cast<uint8_t*>(out), stream)
                : tail::launch(src, h, w, taps, rg, r, eps, scratch,
                               static_cast<float*>(out), stream);
}

// The tail of an enhance plan with impl="fused1" (enhance_plan.cu): u8 q.
int enhance_tail_clahe_configure(int h, int w, int rg, int r, TailPlan* p) {
  return tail::configure<ClaheSrc, uint8_t>(h, w, rg, r, p);
}

int enhance_tail_clahe_launch(const TailPlan& p, const uint8_t* img, int h,
                              int w, const ClaheGeom& g, float scale,
                              const Taps& taps, int rg, int r, float eps,
                              float* scratch, uint8_t* out,
                              cudaStream_t stream) {
  return tail::run(p, ClaheSrc{img, w, g, scale}, h, w, taps, rg, r, eps,
                   scratch, out, stream);
}
