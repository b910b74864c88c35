// CLAHE bilinear 4-LUT mapping of a whole frame.
//
// Replaces tpuimg/kernels/lut.py::clahe_map_full (:341, kernel factory :273)
// and covers what clahe_band_map does for tiny tiles: the TPU forms resolve
// tile indices per static x-run and 32-row block because the TPU has no cheap
// gather; here each thread owns one pixel, computes its own tile indices and
// reads its four table entries, so any tile grid works.
//
// Coordinate math is the reference's (gInterpolateMappingUnroll) and
// tpuimg's, bit for bit: tyf = __fdiv_rn(y + pad_top, th) - 0.5 and
// txf = (x + pad_left) * inv_tw - 0.5 with inv_tw = f32(1)/f32(tw) from the
// host; ty1/tx1 truncate toward zero (ya may be negative at the top border),
// ty2/tx2 clamp to the last tile. The blend is
// (t11*xa1 + t12*xa)*ya1 + (t21*xa1 + t22*xa)*ya with every multiply and add
// rounded on its own (__fmul_rn/__fadd_rn), so nvcc cannot contract it into
// FMAs and the result equals the plain PyTorch version exactly.
//
// Bound on this card: memory traffic, 1 byte in and 4 bytes (f32) or 1 byte
// (u8) out per pixel; the (T, 256) float tables (64 KB for 8x8) stay in
// L1/L2, so the four table reads per pixel are cache hits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kOutF32>
__global__ void __launch_bounds__(kThreads)
clahe_map_kernel(const uint8_t* __restrict__ img, int h, int w,
                 const float* __restrict__ tables, int ytiles, int xtiles,
                 float th, float pad_top, float pad_left, float inv_tw,
                 void* __restrict__ out) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const float tyf = __fsub_rn(__fdiv_rn(__fadd_rn(static_cast<float>(y),
                                                  pad_top), th), 0.5f);
  const float txf = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(x),
                                                  pad_left), inv_tw), 0.5f);
  const int ty1 = __float2int_rz(tyf);
  const int tx1 = __float2int_rz(txf);
  const int ty2 = min(ty1 + 1, ytiles - 1);
  const int tx2 = min(tx1 + 1, xtiles - 1);
  const float ya = __fsub_rn(tyf, static_cast<float>(ty1));
  const float xa = __fsub_rn(txf, static_cast<float>(tx1));
  const float ya1 = __fsub_rn(1.0f, ya);
  const float xa1 = __fsub_rn(1.0f, xa);
  const size_t p = static_cast<size_t>(y) * w + x;
  const int v = img[p];
  const float t11 = __ldg(&tables[(ty1 * xtiles + tx1) * 256 + v]);
  const float t12 = __ldg(&tables[(ty1 * xtiles + tx2) * 256 + v]);
  const float t21 = __ldg(&tables[(ty2 * xtiles + tx1) * 256 + v]);
  const float t22 = __ldg(&tables[(ty2 * xtiles + tx2) * 256 + v]);
  const float top = __fadd_rn(__fmul_rn(t11, xa1), __fmul_rn(t12, xa));
  const float bot = __fadd_rn(__fmul_rn(t21, xa1), __fmul_rn(t22, xa));
  const float o = __fadd_rn(__fmul_rn(top, ya1), __fmul_rn(bot, ya));
  if constexpr (kOutF32) {
    static_cast<float*>(out)[p] = o;
  } else {
    // float -> uchar assignment of the reference: truncate, clamp
    static_cast<uint8_t*>(out)[p] =
        static_cast<uint8_t>(fminf(fmaxf(truncf(o), 0.0f), 255.0f));
  }
}

}  // namespace

// out is (h, w) float32 when out_f32, else uint8.
extern "C" int tpuimg_clahe_map(const uint8_t* img, int h, int w,
                                const float* tables, int ytiles, int xtiles,
                                int th, int pad_top, int pad_left,
                                float inv_tw, int out_f32, void* out,
                                cudaStream_t stream) {
  const dim3 grid((w + kThreads - 1) / kThreads, h);
  const float thf = static_cast<float>(th);
  const float ptf = static_cast<float>(pad_top);
  const float plf = static_cast<float>(pad_left);
  if (out_f32) {
    clahe_map_kernel<true><<<grid, kThreads, 0, stream>>>(
        img, h, w, tables, ytiles, xtiles, thf, ptf, plf, inv_tw, out);
  } else {
    clahe_map_kernel<false><<<grid, kThreads, 0, stream>>>(
        img, h, w, tables, ytiles, xtiles, thf, ptf, plf, inv_tw, out);
  }
  return static_cast<int>(cudaGetLastError());
}
