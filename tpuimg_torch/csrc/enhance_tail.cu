// The enhance pipeline's tail on a float32 frame f:
// q = guided(I=f, p=gaussian(f, rg), r, eps), in one launch.
//
// Replaces tpuimg/kernels/boxsum.py::enhance_tail_pallas (:396; strip :335,
// math _tail_chain :295). The kernel body (the guided strip walker with an
// on-chip producer of I = f and p = gaussian(f)), its design and its bounds
// are in enhance_tail.cuh, shared with the CLAHE-fused tail
// (enhance_tail_clahe.cu); here its producer reads f from device memory,
// once per pixel of a strip and its halo, rows copied by cp.async, and
// writes q as float32 or, for enhance, as the u8 frame it returns. Bound
// 0.0198 ms at 4K (bytes; 0.0124 with u8 q); 0.2918 ms on an NVIDIA H100
// 80GB HBM3 at 700.00 W (chip_smoke.py), where the gaussian kernel then the
// guided walker take 0.3160.
#include "enhance_tail.cuh"

namespace {

struct FrameSrc {
  using Raw = float;
  static constexpr bool kAsync = true;  // f rows copied by cp.async
  const float* f;
  int w;
  __device__ __forceinline__ const float* ptr(int y, int x) const {
    return f + static_cast<size_t>(y) * w + x;
  }
  __device__ __forceinline__ float raw(int y, int x) const {
    return __ldg(f + static_cast<size_t>(y) * w + x);
  }
  __device__ __forceinline__ float value(float v, int, int) const {
    return v;
  }
};

}  // namespace

// f: (h, w) float32; taps.w[0 .. 2*rg]: the gaussian weights; scratch:
// tpuimg_enhance_tail_scratch_floats(...) floats (null when 0); out: (h, w)
// uint8 when out_u8 (q stored as pipeline.py's _to_u8 rounds it), else
// float32.
extern "C" int tpuimg_enhance_tail(const float* f, int h, int w,
                                   Taps taps, int rg, int r,
                                   float eps, float* scratch, int out_u8,
                                   void* out, cudaStream_t stream) {
  const FrameSrc src{f, w};
  return out_u8 ? tail::launch(src, h, w, taps, rg, r, eps, scratch,
                               static_cast<uint8_t*>(out), stream)
                : tail::launch(src, h, w, taps, rg, r, eps, scratch,
                               static_cast<float*>(out), stream);
}

// The floats of device scratch either tail needs at these arguments (its p
// rings, and on the scratch route its workspace), -1 for arguments the tail
// refuses, or -2 - a CUDA error.
extern "C" long long tpuimg_enhance_tail_scratch_floats(int h, int w, int rg,
                                                        int r) {
  return tail::scratch_floats(h, w, rg, r);
}

// 1 where either tail keeps its workspace in shared memory at these radii, 0
// on the scratch route
extern "C" int tpuimg_enhance_tail_shared(int rg, int r) {
  return tail::smem_bytes(rg, r) > 0 ? 1 : 0;
}
