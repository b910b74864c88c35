// dst = table[img]: one 256-entry table for a frame, or one table per frame.
//
// Replaces tpuimg/kernels/lut.py::lut_gather (:77) and lut_gather_frames
// (:193). The TPU gathers with 128-lane dynamic-gathers from a table held in
// VMEM (u8 tables packed four entries to a word). Here a block stages its
// frame's table in shared memory (256 B for 1-byte entries, 1 KB for 4-byte
// ones) and each thread looks up kItems pixels. Entries are copied as raw
// bytes or 4-byte words, never converted, so every bit of the selected entry
// arrives (a float32 table's -0.0 and NaN payloads included).
//
// Bound on this card: device memory, one byte read and one entry written per
// pixel (16.6 MB at 4K for a u8 table, 41.5 MB for a 4-byte one). Each
// thread's kItems loads are issued before its lookups, to keep loads in
// flight; byte loads and stores along a warp are contiguous, so every 32-byte
// sector is used whole whatever the frame's alignment.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // == 256 table entries: one each to stage
constexpr int kItems = 4;
constexpr int kMaxGridY = 65535;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lut_gather_kernel(const uint8_t* __restrict__ img, long long n, int frames,
                  const T* __restrict__ tables, int tstride,
                  T* __restrict__ out) {
  __shared__ T tab[256];
  for (int f = blockIdx.y; f < frames; f += gridDim.y) {
    tab[threadIdx.x] = tables[static_cast<long long>(f) * tstride +
                              threadIdx.x];
    __syncthreads();
    const uint8_t* src = img + static_cast<long long>(f) * n;
    T* dst = out + static_cast<long long>(f) * n;
    const long long i0 =
        static_cast<long long>(blockIdx.x) * (kThreads * kItems) +
        threadIdx.x;
    uint8_t v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = i0 + k * kThreads;
      v[k] = i < n ? src[i] : 0;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = i0 + k * kThreads;
      if (i < n) dst[i] = tab[v[k]];
    }
    __syncthreads();  // the next frame restages tab
  }
}

template <typename T>
void launch_gather(const uint8_t* img, long long n, int frames,
                   const void* tables, int tstride, void* out,
                   cudaStream_t stream) {
  const long long per_block = kThreads * kItems;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block),
                  static_cast<unsigned>(std::min(frames, kMaxGridY)));
  lut_gather_kernel<T><<<grid, kThreads, 0, stream>>>(
      img, n, frames, static_cast<const T*>(tables), tstride,
      static_cast<T*>(out));
}

}  // namespace

// img: (frames, n) u8; tables: 256 entries of elem_bytes (1 or 4) each, frame
// f's at tables + f * tstride entries (tstride 0: one shared table); out:
// (frames, n) entries of elem_bytes.
extern "C" int tpuimg_lut_gather(const uint8_t* img, long long n, int frames,
                                 const void* tables, int tstride,
                                 int elem_bytes, void* out,
                                 cudaStream_t stream) {
  if (elem_bytes == 1) {
    launch_gather<uint8_t>(img, n, frames, tables, tstride, out, stream);
  } else if (elem_bytes == 4) {
    launch_gather<unsigned int>(img, n, frames, tables, tstride, out, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
