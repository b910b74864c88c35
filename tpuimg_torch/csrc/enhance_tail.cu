// The enhance pipeline's tail on a float32 frame f:
// q = guided(I=f, p=gaussian(f, rg), r, eps), in one launch.
//
// Replaces tpuimg/kernels/boxsum.py::enhance_tail_pallas (:396; strip :335,
// math _tail_chain :295). The kernel body, its design and its bounds are in
// enhance_tail.cuh, shared with the CLAHE-fused tail (enhance_tail_clahe.cu);
// here its producer reads f from device memory.
#include "enhance_tail.cuh"

namespace {

struct FrameSrc {
  const float* f;
  int w;
  __device__ __forceinline__ float operator()(int y, int x) const {
    return f[static_cast<size_t>(y) * w + x];
  }
};

}  // namespace

// f, out: (h, w) float32; taps.w[0 .. 2*rg]: the gaussian weights.
extern "C" int tpuimg_enhance_tail(const float* f, int h, int w,
                                   Taps taps, int rg, int r,
                                   float eps, float* out,
                                   cudaStream_t stream) {
  return tail::launch(FrameSrc{f, w}, h, w, taps, rg, r, eps, out, stream);
}
