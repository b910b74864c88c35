// Global, per-frame and per-group 256-bin histograms: one kernel body, over
// u8 pixels or over int32 words of four packed u8 pixels.
//
// Replaces tpuimg/kernels/hist.py::hist256_pallas (:115),
// hist256_frames_pallas (:145) and hist256_groups_pallas (:126), which share
// one pallas_call (_run_groups, :99) that counts with nibble one-hot matmuls
// because the TPU has no atomics. Every form is one (G, P) problem here: G
// groups of P contiguous bytes (a frame is G = 1; a contiguous (B, H, W)
// stack is G = B, P = H * W). The counting is what the reference's
// gCalcHistUnroll8 does: shared-memory atomics into one 256-bin histogram
// per block, added into a zeroed global (G, 256) int32 buffer at the end.
// Counts are exact, with no padding corrections: the TPU's bin-0 fix-ups
// exist only because of its 32x128 alignment pads.
//
// The second entry, tpuimg_hist256_packed, replaces
// hist256_groups_pallas_packed (:167, the same pallas_call with
// _hist_group_kernel_packed): (G, P4) int32 words, each holding four pixels
// little-endian, counted byte by byte. It is the same body reading words: a
// group's base is 4-byte aligned there, not 1.
//
// Bound on this card: one byte read and one shared-memory atomic per pixel
// (8.3 MB and 8.3 M atomics for a 4K frame); the atomics set the time. A
// thread loads 16 bytes at a time, so it issues 16 independent atomics per
// load. A group's base (g * P units) is 16-byte aligned only by chance, so
// block 0 of each group counts the units before the first 16-byte boundary
// and after the last one by one. A flat frame sends every atomic of a warp
// to one bin: the hardware serialises them, which is slow but exact.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // == 256 bins: one bin per thread to zero/flush
// 16-byte vectors a thread counts per block, for sizing the grid: a 4K frame
// runs as 254 blocks, 16 frames of 1080p as 16 x 64
constexpr int kVecPerThread = 8;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ void count_word(unsigned int word, int* hist) {
  atomicAdd(&hist[word & 0xFFu], 1);
  atomicAdd(&hist[(word >> 8) & 0xFFu], 1);
  atomicAdd(&hist[(word >> 16) & 0xFFu], 1);
  atomicAdd(&hist[word >> 24], 1);
}

// unit i of a group: a pixel (kUnit 1) or a word of four (kUnit 4)
template <int kUnit>
__device__ __forceinline__ void count_unit(const uint8_t* base, long long i,
                                           int* hist) {
  if constexpr (kUnit == 1) {
    atomicAdd(&hist[base[i]], 1);
  } else {
    count_word(reinterpret_cast<const unsigned int*>(base)[i], hist);
  }
}

// x: groups of p units of kUnit bytes each
template <int kUnit>
__global__ void __launch_bounds__(kThreads)
hist256_kernel(const uint8_t* __restrict__ x, int groups, long long p,
               int* __restrict__ out) {
  constexpr int kPerVec = 16 / kUnit;  // units in a 16-byte vector
  __shared__ int hist[256];
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    hist[threadIdx.x] = 0;
    __syncthreads();
    const uint8_t* base = x + static_cast<long long>(g) * p * kUnit;
    const long long head = min(
        p, static_cast<long long>(
               ((16 - (reinterpret_cast<uintptr_t>(base) & 15)) & 15) /
               kUnit));
    const long long nvec = (p - head) / kPerVec;
    const uint4* vec = reinterpret_cast<const uint4*>(base + head * kUnit);
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         i < nvec; i += stride) {
      const uint4 v = vec[i];
      count_word(v.x, hist);
      count_word(v.y, hist);
      count_word(v.z, hist);
      count_word(v.w, hist);
    }
    if (blockIdx.x == 0) {  // head and tail: fewer than 16 bytes each
      const long long tail = head + nvec * kPerVec + threadIdx.x;
      if (threadIdx.x < head) count_unit<kUnit>(base, threadIdx.x, hist);
      if (tail < p) count_unit<kUnit>(base, tail, hist);
    }
    __syncthreads();
    const int v = hist[threadIdx.x];
    if (v) atomicAdd(&out[static_cast<long long>(g) * 256 + threadIdx.x], v);
    __syncthreads();  // the next group zeroes hist
  }
}

template <int kUnit>
int launch_hist(const uint8_t* x, int groups, long long p, int* out,
                cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * kVecPerThread;
  const long long chunks = (p * kUnit / 16 + per_block) / per_block;
  const dim3 grid(static_cast<unsigned>(std::min(chunks, 65535LL)),
                  static_cast<unsigned>(std::min(groups, kMaxGridY)));
  hist256_kernel<kUnit><<<grid, kThreads, 0, stream>>>(x, groups, p, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (groups, p) u8, contiguous; out: zeroed (groups, 256) int32.
extern "C" int tpuimg_hist256(const uint8_t* x, int groups, long long p,
                              int* out, cudaStream_t stream) {
  return launch_hist<1>(x, groups, p, out, stream);
}

// x: (groups, p4) int32 words of four u8 pixels (little-endian), contiguous;
// out: zeroed (groups, 256) int32.
extern "C" int tpuimg_hist256_packed(const int32_t* x, int groups,
                                     long long p4, int* out,
                                     cudaStream_t stream) {
  return launch_hist<4>(reinterpret_cast<const uint8_t*>(x), groups, p4, out,
                        stream);
}
