// The enhance pipeline's tail on a float32 frame f:
// q = guided(I=f, p=gaussian(f, rg), r, eps), in two launches of one call.
//
// Replaces tpuimg/kernels/boxsum.py::enhance_tail_pallas (:396; strip :335,
// math _tail_chain :295). The kernel body (two strip walks of guided.cu's
// twopass design: walk 1 makes I = f and p = gaussian(f) on chip and writes a
// and b, walk 2 box-sums them and writes q), its design and its bounds are in
// enhance_tail.cuh, shared with the CLAHE-fused tail
// (enhance_tail_clahe.cu); here walk 1 reads f from device memory, once per
// pixel of a strip and its halo, rows copied by cp.async, walk 2 reads f
// again at the output pixels, and q is written as float32 or, for enhance, as
// the u8 frame it returns. The function's bound is 0.0124 ms at 4K (f32 f
// in, u8 q out), the design's own floor about 25 bytes a pixel (a and b
// through device memory); times on the card in PERF.md §5 and §6.
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
  // rows that walk 1 may copy 16 bytes at a time
  bool aligned(int w_) const {
    return w_ % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0;
  }
};

}  // namespace

// f: (h, w) float32; taps.w[0 .. 2*rg]: the gaussian weights; scratch:
// tpuimg_enhance_tail_scratch_floats(...) floats; out: (h, w)
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

// The tail of an enhance plan (enhance_plan.cu): f the plan's blend, u8 q.
int enhance_tail_configure(int h, int w, int rg, int r, TailPlan* p) {
  return tail::configure<FrameSrc, uint8_t>(h, w, rg, r, p);
}

int enhance_tail_launch(const TailPlan& p, const float* f, int h, int w,
                        const Taps& taps, int rg, int r, float eps,
                        float* scratch, uint8_t* out, cudaStream_t stream) {
  return tail::run(p, FrameSrc{f, w}, h, w, taps, rg, r, eps, scratch, out,
                   stream);
}

// The floats of device scratch either tail needs at these arguments (the a
// and b planes, and on walk 1's scratch route its rings of the leaving rows),
// or -1 for arguments the tail refuses.
extern "C" long long tpuimg_enhance_tail_scratch_floats(int h, int w, int rg,
                                                        int r) {
  return tail::scratch_floats(h, w, rg, r);
}

// 1 where either tail's walk 1 keeps the leaving rows' I and p in shared
// memory at these radii, 0 on its scratch route (rings in device memory)
extern "C" int tpuimg_enhance_tail_shared(int rg, int r) {
  return tail::ring_bytes(rg, r) > 0 ? 1 : 0;
}
