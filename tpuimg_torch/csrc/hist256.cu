// Global, per-frame and per-group 256-bin histograms: one kernel body, over
// u8 pixels or over int32 words of four packed u8 pixels.
//
// Replaces tpuimg/kernels/hist.py::hist256_pallas (:115),
// hist256_frames_pallas (:145) and hist256_groups_pallas (:126), which share
// one pallas_call (_run_groups, :99) that counts with nibble one-hot matmuls
// because the TPU has no atomics. Every form is one (G, P) problem here: G
// groups of P contiguous bytes (a frame is G = 1; a contiguous (B, H, W)
// stack is G = B, P = H * W). Counts are exact, with no padding
// corrections: the TPU's bin-0 fix-ups exist only because of its 32x128
// alignment pads.
//
// The second entry, tpuimg_hist256_packed, replaces
// hist256_groups_pallas_packed (:167, the same pallas_call with
// _hist_group_kernel_packed): (G, P4) int32 words, each holding four pixels
// little-endian, counted byte by byte. It is the same body reading words: a
// group's base is 4-byte aligned there, not 1.
//
// Bound on this card: one byte read a pixel (8.3 MB for a 4K frame). The
// first design (the reference's gCalcHistUnroll8: every thread of a block
// adding into one shared histogram, added into a zeroed global one) took
// two launches a call, a memset and the kernel, and sized its grid at p /
// 32 KB blocks: 64 at 1080p for 132 SMs, 1 for a group of 8 KB. This
// design:
// - One launch and no memset. The grid fills the card (kBlocksPerSm blocks
//   an SM, each at least kMinBlockVecs vectors of 16 bytes): bx blocks a
//   group. With bx = 1 a block writes its group's counts; otherwise each
//   block adds its counts into the group's accumulator in a workspace
//   (global atomics, one a bin), and the group's last block, which finds
//   out through a ticket (__threadfence, then atomicInc with limit bx - 1,
//   which wraps the ticket back to 0 by itself), moves the accumulator into
//   the output and leaves it zeroed (atomicExch). The workspace belongs to
//   one (device, stream) (kernels/hist.py) and is zeroed once, when made;
//   every call leaves it zeroed.
// - Each warp counts into a 256-bin sub-histogram of its own in shared
//   memory, one atomic a byte, so that warps never wait on each other's
//   bins. A thread loads 16 bytes at a time and issues their 16 atomics
//   together.
// - A group's base (g * P units) is 16-byte aligned only by chance, so
//   block 0 of each group counts the units before the first 16-byte
//   boundary and after the last one by one. Groups past gridDim.y (more
//   than 65535) are walked by the block rows, with bx = 1.
//
// HE's tables (tpuimg_he_tables): the same launch ends, in the block that
// holds a group's final counts (its only block where bx = 1, else the last
// one through the ticket), with the group's u8 table instead of its
// histogram: bin b in thread b, an inclusive scan of the 256 counts (warp
// shuffles, then the 8 warp totals through shared memory), then
// table[b] = rint(min(255, cdf[b] * factor)), factor the host's f32 of
// 256 / P. Each step is ops/histogram.py::_he_tables's: the cdf rounded to
// f32 to nearest even, one f32 multiply (no division, no FMA), min before
// the half-to-even rounding; so the tables are its bit for bit. On 16
// 1080p frames the launch takes 0.0212 ms of device time by the profiler
// against the histograms' 0.0210 (NVIDIA H100 80GB HBM3, 700 W), and the
// six PyTorch ops that built the tables after it (seven kernels, 0.015 ms
// of device time and 0.06-0.08 ms of host time a call) are gone. The
// histogram entries run the instance without it.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // == 256 bins: one bin a thread to sum/flush
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr long long kMinBlockVecs = 512;  // 8 KB a block at least
constexpr int kMaxGridY = 65535;
// groups that may be counted by several blocks each, and so need the
// workspace: kernels/hist.py HIST_SPLIT_MAX_GROUPS
constexpr int kMaxSplitGroups = 1024;

// the grid: bx blocks a group (bx > 1 only when every group has its row)
struct HistPlan {
  int bx, by;
};

int plan_hist(int groups, long long bytes, HistPlan* plan) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long target = static_cast<long long>(sms) * kBlocksPerSm;
  const long long by_data = std::max(1LL, bytes / 16 / kMinBlockVecs);
  long long bx = std::min(by_data, (target + groups - 1) / groups);
  if (groups > kMaxSplitGroups) bx = 1;
  plan->bx = static_cast<int>(std::max(1LL, std::min(bx, 65535LL)));
  plan->by = std::min(groups, kMaxGridY);
  return 0;
}

// unit i of a group: a pixel (kUnit 1) or a word of four (kUnit 4)
template <int kUnit>
__device__ __forceinline__ void count_unit(const uint8_t* base, long long i,
                                           int* hist) {
  if constexpr (kUnit == 1) {
    atomicAdd(&hist[base[i]], 1);
  } else {
    count_word(reinterpret_cast<const unsigned*>(base)[i], hist);
  }
}

// HE's table of one group, thread b holding bin b's final count v:
// dst[b] = rint(min(255, cdf[b] * factor)), cdf the inclusive scan of the
// counts (ops/histogram.py::_he_tables). The whole block calls it.
__device__ __forceinline__ void he_table(int v, float factor, uint8_t* dst) {
  __shared__ int warp_cdf[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int c = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, c, d);
    if (lane >= d) c += up;
  }
  if (lane == 31) warp_cdf[warp] = c;
  __syncthreads();
  for (int k = 0; k < warp; ++k) c += warp_cdf[k];
  dst[tid] = static_cast<uint8_t>(__float2int_rn(
      fminf(__fmul_rn(__int2float_rn(c), factor), 255.f)));
}

// x: groups of p units of kUnit bytes each; ws: with gridDim.x > 1, the
// groups' accumulators ((groups, 256) int32) and tickets (groups), zero.
// A group's final counts go to out[g] or, kTables, its HE table (factor
// the f32 of 256 / p) to tables[g].
template <int kUnit, bool kTables>
__global__ void __launch_bounds__(kThreads)
hist256_kernel(const uint8_t* __restrict__ x, int groups, long long p,
               int* __restrict__ ws, int* __restrict__ out, float factor,
               uint8_t* __restrict__ tables) {
  constexpr int kPerVec = 16 / kUnit;  // units in a 16-byte vector
  __shared__ int sub[kWarps * 256];
  __shared__ int last;
  const int tid = threadIdx.x;
  int* hist = sub + (tid >> 5) * 256;
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
#pragma unroll
    for (int k = 0; k < kWarps; ++k) sub[k * 256 + tid] = 0;
    __syncthreads();
    const uint8_t* base = x + static_cast<long long>(g) * p * kUnit;
    const long long head = min(
        p, static_cast<long long>(
               ((16 - (reinterpret_cast<uintptr_t>(base) & 15)) & 15) /
               kUnit));
    const long long nvec = (p - head) / kPerVec;
    const uint4* vec = reinterpret_cast<const uint4*>(base + head * kUnit);
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
         i < nvec; i += stride) {
      const uint4 v = __ldg(vec + i);
      count_word(v.x, hist);
      count_word(v.y, hist);
      count_word(v.z, hist);
      count_word(v.w, hist);
    }
    if (blockIdx.x == 0) {  // head and tail: fewer than 16 bytes each
      const long long tail = head + nvec * kPerVec + tid;
      if (tid < head) count_unit<kUnit>(base, tid, hist);
      if (tail < p) count_unit<kUnit>(base, tail, hist);
    }
    __syncthreads();
    int v = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += sub[k * 256 + tid];
    const long long at = static_cast<long long>(g) * 256;
    if (gridDim.x == 1) {
      if constexpr (kTables) {
        he_table(v, factor, tables + at);
      } else {
        out[at + tid] = v;
      }
    } else {
      int* acc = ws + static_cast<long long>(g) * 256;
      unsigned* ticket =
          reinterpret_cast<unsigned*>(ws) + static_cast<long long>(groups) *
                                                256 + g;
      if (v) atomicAdd(&acc[tid], v);
      __threadfence();  // the adds are visible before the ticket is taken
      __syncthreads();
      if (tid == 0) last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
      __syncthreads();
      if (last) {  // the whole block or none of it
        __threadfence();
        const int total = atomicExch(&acc[tid], 0);
        if constexpr (kTables) {
          he_table(total, factor, tables + at);
        } else {
          out[at + tid] = total;
        }
      }
    }
    __syncthreads();  // the next group zeroes sub
  }
}

template <int kUnit, bool kTables>
int launch_hist(const uint8_t* x, int groups, long long p, int* ws,
                long long ws_ints, int* out, float factor, uint8_t* tables,
                cudaStream_t stream) {
  if (groups < 1 || p < 0) return static_cast<int>(cudaErrorInvalidValue);
  HistPlan plan;
  const int err = plan_hist(groups, p * kUnit, &plan);
  if (err != 0) return err;
  if (plan.bx > 1 && (ws == nullptr || ws_ints < 257LL * groups)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(plan.bx),
                  static_cast<unsigned>(plan.by));
  hist256_kernel<kUnit, kTables><<<grid, kThreads, 0, stream>>>(
      x, groups, p, ws, out, factor, tables);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (groups, p) u8, contiguous; ws: for groups <= kMaxSplitGroups, 257 *
// groups zeroed int32 that only this stream's calls use, left zeroed (else
// unused); out: (groups, 256) int32, written whole.
extern "C" int tpuimg_hist256(const uint8_t* x, int groups, long long p,
                              int* ws, long long ws_ints, int* out,
                              cudaStream_t stream) {
  return launch_hist<1, false>(x, groups, p, ws, ws_ints, out, 0.f, nullptr,
                               stream);
}

// x: (groups, p4) int32 words of four u8 pixels (little-endian),
// contiguous; ws and out as tpuimg_hist256's.
extern "C" int tpuimg_hist256_packed(const int32_t* x, int groups,
                                     long long p4, int* ws, long long ws_ints,
                                     int* out, cudaStream_t stream) {
  return launch_hist<4, false>(reinterpret_cast<const uint8_t*>(x), groups,
                               p4, ws, ws_ints, out, 0.f, nullptr, stream);
}

// x, groups, p and ws as tpuimg_hist256's; factor: the host's f32 of
// 256 / p; tables: (groups, 256) u8, written whole, each group's HE table
// rint(min(255, cdf * factor)) of its counts.
extern "C" int tpuimg_he_tables(const uint8_t* x, int groups, long long p,
                                int* ws, long long ws_ints, float factor,
                                uint8_t* tables, cudaStream_t stream) {
  return launch_hist<1, true>(x, groups, p, ws, ws_ints, nullptr, factor,
                              tables, stream);
}
