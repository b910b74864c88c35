// The enhance pipeline's tail: q = guided(I=f, p=gaussian(f, rg), r, eps),
// reflect-101 borders, 1/ksz^2 normalisation, in one launch, templated on
// the producer of f. enhance_tail.cu reads f from a float32 frame;
// enhance_tail_clahe.cu computes it from the u8 frame through the CLAHE
// blend. Both instantiate this one body, so their tail arithmetic is the
// same code.
//
// The algebra is tpuimg/kernels/boxsum.py::_tail_chain's: on the frame
// extended by reflect-101, smooth f with the separable gaussian (down the
// columns, then along the rows, each in the symmetric form w[rg]*c +
// sum w[rg - m]*(left + right)), take the four box sums of I = f, p, I*p and
// I*I, form a and b, box-sum them and emit q. The smoothed frame never
// reaches device memory.
//
// Design on this card: the guided filter's strip walker (walker.cuh, the
// body guided.cu's onepass entries run; its design in guided.cu's header),
// with a producer that makes I and p on chip. What held the tile kernel it
// replaces at 46x (fused) and 81x (fused1) its bound was on-chip work:
// direct (2r + 1)-tap window sums in four stages (~250 shared loads a pixel
// at r = 8), a 32x32 tile's (32 + 2(2r + rg))^2 halo re-staged per tile, the
// gaussian run over 4x the tile, ~100 KB of shared memory a block, and in
// fused1 the CLAHE blend evaluated ~4.5 times a pixel. Now, per step of the
// walker (kRows walker rows):
// - f is produced once per pixel of the strip and its halo (ti + 2rg
//   columns), reflect-101 mapped, two steps ahead of the walker, into a ring
//   of f rows (fr): a float frame's rows by cp.async, the CLAHE blend's from
//   loads issued at the top of a step and turned into f after stage 4.
// - the gaussian's column pass for the next step's rows (T) runs on the two
//   warps that the walker's stage 4 leaves idle, beside it; its row pass runs
//   in the walker's vertical pass, a thread a column, for all kRows rows
//   before the running sums take the first. Both loop over the taps outside
//   the rows, so that a tap's loads for every row are in flight together,
//   and the enhance default's gaussian radius (kFixedRg = 2) has its tap
//   loops unrolled at compile time: a run-time tap loop inside each row
//   waits on every load (0.12 of 0.39 ms at 4K on an NVIDIA H100 80GB HBM3
//   at 700.00 W, PERF.md).
// - p enters the running sums there and goes into a ring of the last
//   2r + 1 + kRows rows in device memory (the block's own slice of a
//   scratch, 8 KB at r = 8, which stays in L2); the next step's leaving rows
//   come back into shared memory by cp.async after stage 4. I at the leaving
//   rows and at the output pixels is read from fr. No phase waits on device
//   memory and the producer adds no barrier to the walker's five.
// - the walker does the rest: f64 running column sums, f32 running row
//   sums, a and b once a pixel, one wave of blocks.
// Bound: the tail reads f (4 bytes a pixel as float32, 1 as fused1's u8
// frame) and writes q (4 bytes as float32, 1 as the u8 frame that enhance
// returns) and does a constant number of operations, so it is bound by
// bytes: at 4K 0.0198 ms for 8 bytes a pixel, 0.0124 for 5 (f32 f and u8 q,
// or fused1 with f32 q), 0.0050 for fused1's 2. Shared memory at
// r = 8, rg = 2: 37,392 bytes; the launch bound (5 blocks an SM, 96
// registers) holds 5, which times faster than 6 at 80 registers. The
// shared-memory route takes a footprint up to 227 KB (r <= 53 at rg <= 2,
// r <= 48 at rg = 16); past it the same body runs with its workspace in the
// device-memory scratch too (tpuimg_enhance_tail_scratch_floats sizes it),
// up to kTailMaxRadius = 64 and rg <= 16 (kMaxTaps).
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py), 4K,
// r = 8, rg = 2: 0.2918 ms, fused1 0.3580 (the tile kernel 0.9078 and
// 1.0073), where the gaussian kernel then the guided walker take 0.3160.
#pragma once

#include "walker.cuh"

constexpr int kMaxTaps = 33;        // gaussian radius <= 16
constexpr int kTailMaxRadius = 64;  // the guided frame entry's range
constexpr long long kSmemPerSm = 233472;  // an H100 SM's shared memory
// the enhance pipeline's default gaussian radius, which the shared-memory
// route runs with its tap loops unrolled at compile time
constexpr int kFixedRg = 2;

// the taps travel by value in the launch's parameter space: no device
// buffer, no host-to-device copy before the launch
struct Taps {
  float w[kMaxTaps];
};

namespace tail {

using walker::kRows;
using walker::kStrip;
using walker::kWalkThreads;

// The producer's shared layout in floats: the f ring, lf rows of tf columns:
// from the rows whose I the step's q takes, 2r back, or its leaving rows, or
// the gaussian's, to two steps ahead, a step more than they need, because
// the step's last phase stores while it reads (ti = kStrip + 4r, tf = ti +
// 2rg). The gaussian's column pass for a step (T, kRows rows of tf) and the p
// of the step's leaving rows (kRows rows of ti, 16-byte aligned) live in the
// walker's hab, which is free from stage 4 to the next step's stage 2. The p
// ring (kr rows of ti) is the block's own slice of a device-memory scratch.
struct TailGeom {
  int ti, tf, lf, kr;
  __host__ __device__ TailGeom(int rg, int r)
      : ti(kStrip + 4 * r),
        tf(kStrip + 4 * r + 2 * rg),
        lf((2 * r + kRows > rg ? 2 * r + kRows : rg) + rg + 2 * kRows),
        kr(2 * r + 1 + kRows) {}
  __host__ __device__ long long floats() const {
    return static_cast<long long>(lf) * tf;
  }
  __host__ __device__ long long ring() const {
    return static_cast<long long>(kr) * ti;
  }
};

__host__ __device__ inline walker::Workspace workspace(int rg, int r) {
  return walker::workspace_of(r, false, TailGeom(rg, r).floats(), false);
}

// a block's floats of device scratch: the p ring, and on the scratch route
// the walker's workspace before it
template <bool kShared>
__host__ __device__ inline long long block_floats(int rg, int r) {
  return (kShared ? 0 : workspace(rg, r).total) + TailGeom(rg, r).ring();
}

// The walker's producer for the tail. Src gives f at an in-frame pixel in
// two parts, so that a thread's loads are in flight while it does other
// work: raw(y, x), the load, and value(raw, y, x), f; or, where
// Src::kAsync, ptr(y, x), the float f, copied straight into the f ring with
// cp.async. W: the 2rg + 1 taps in shared memory. kRg: the gaussian radius
// fixed at compile time, or -1 (rg at run time).
//
// Rows run two steps ahead. A Src that computes f (the CLAHE blend) issues,
// at the top of step s, the loads of one of step s + 2's new f rows a warp
// (kHold a lane, held in registers through the step), and after stage 4
// turns them into f in the f ring (the slot of a row the walker has left);
// a Src that is a float frame has them copied there by cp.async after stage
// 4 of step s, waited on before stage 4 of step s + 1, where they are first
// read. The two warps that stage 4 leaves idle compute the gaussian down the
// columns for step s + 1 into T beside it. So no phase waits on device
// memory and the producer adds no barrier. The walker's vertical pass takes
// I from the f ring and p, the gaussian along T's row, for all kRows rows
// before its running sums, and stores p in the p ring; the p of the next
// step's leaving rows comes back from the ring into shared memory by
// cp.async after stage 4 (the scratch route reads the ring directly).
template <class Src, bool kShared, int kRg>
struct TailRows {
  static constexpr bool kSelf = false;
  static constexpr bool kCentre = true;
  static constexpr bool kInRange = true;  // f and p in [0, 1]
  static constexpr bool kAsync = Src::kAsync && kShared;
  static constexpr int kHold = 4;  // loads a lane holds: rows of <= 128
  using Raw = typename Src::Raw;
  Src src;
  const float* W;
  float* fr;   // f ring: walker row u in slot (u + rg) mod lf
  float* T;    // the column pass of the next step's rows
  float* lpb;  // p at this step's leaving rows (the shared-memory route)
  float* gp;   // the p ring, device memory: walker row u in slot u mod kr
  TailGeom g;
  int e0, x0, h, w, r, rg;
  int fb;  // f slot of this step's first walker row
  int pb;  // p slot of this step's first walker row
  Raw hold[kHold];
  float ic[kRows], pc[kRows];  // I and p of the step's rows at a column

  __device__ __forceinline__ int column_x(int c) const {
    return reflect101_fast(x0 - 2 * r - rg + c, w);
  }

  // f at walker row u into f slot `slot`, a warp along the row, all of a
  // lane's loads issued before the first store
  __device__ __forceinline__ void fill(int u, int slot, int lane) const {
    const int y = reflect101_fast(e0 + u, h);
    for (int c0 = lane; c0 < g.tf; c0 += 32 * kHold) {
      Raw v[kHold];
#pragma unroll
      for (int j = 0; j < kHold; ++j) {
        const int c = c0 + 32 * j;
        if (c < g.tf) v[j] = src.raw(y, column_x(c));
      }
#pragma unroll
      for (int j = 0; j < kHold; ++j) {
        const int c = c0 + 32 * j;
        if (c < g.tf) fr[slot * g.tf + c] = src.value(v[j], y, column_x(c));
      }
    }
  }

  // acc[i] = W[rg] x_i(0) + sum over m = 1 .. rg of W[rg - m] (x_i(-m) +
  // x_i(m)), in that order (the plain version's), for the kRows rows i at
  // once, x_i(d) = at(i, d): the taps outer, so that a tap's loads for every
  // row are in flight together; with rg fixed at compile time (kRg >= 0)
  // every load of every tap
  template <class At>
  __device__ __forceinline__ void gauss_rows(At at, float* acc) const {
    const int n = kRg >= 0 ? kRg : rg;
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = W[n] * at(i, 0);
#pragma unroll
    for (int m = 1; m <= n; ++m) {
      const float wm = W[n - m];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] += wm * (at(i, -m) + at(i, m));
    }
  }

  // T = the gaussian down the columns for walker rows u0 .. u0 + kRows - 1,
  // whose f rows u0 - rg .. start at f slot f0: columns c0, c0 + stride, ...
  __device__ __forceinline__ void column_pass(int f0, int c0,
                                              int stride) const {
    if (f0 < 0) f0 += g.lf;
    if (f0 >= g.lf) f0 -= g.lf;
    for (int c = c0; c < g.tf; c += stride) {
      float acc[kRows];
      gauss_rows(
          [&](int i, int d) {
            int sc = f0 + i + rg + d;  // in [0, 2 lf)
            if (sc >= g.lf) sc -= g.lf;
            return fr[sc * g.tf + c];
          },
          acc);
#pragma unroll
      for (int i = 0; i < kRows; ++i) T[i * g.tf + c] = acc[i];
    }
  }

  // f for the first two steps (walker rows -rg .. 2 kRows - 1 + rg, in slots
  // 0 ..), then T for the first
  __device__ __forceinline__ void begin(int) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int t = warp; t < 2 * rg + 2 * kRows; t += kWalkThreads / 32) {
      fill(t - rg, t, lane);
    }
    __syncthreads();
    column_pass(0, threadIdx.x, kWalkThreads);
    fb = rg;
    pb = 0;
  }

  // the row warp u_new(s) = (s + 2) kRows + rg + warp: step s + 2's new f
  // rows, a warp each
  __device__ __forceinline__ int new_row(int s) const {
    return (s + 2) * kRows + rg + static_cast<int>(threadIdx.x >> 5);
  }

  // the f slot of new_row(s): a row the walker has left
  __device__ __forceinline__ int new_slot() const {
    const int slot = fb + 2 * kRows + rg + static_cast<int>(threadIdx.x >> 5);
    return slot >= g.lf ? slot - g.lf : slot;
  }

  // wait for the p rows copied after the last step's stage 4 (the newest
  // group, f rows, may stay in flight); issue the loads of this lane's first
  // kHold columns of its new row
  __device__ __forceinline__ void top(int s, int steps) {
    if constexpr (kShared) walker::cp_async_wait_one();
    if constexpr (!kAsync) {
      if (s + 2 >= steps) return;
      const int y = reflect101_fast(e0 + new_row(s), h);
      const int lane = threadIdx.x & 31;
#pragma unroll
      for (int j = 0; j < kHold; ++j) {
        const int c = lane + 32 * j;
        if (c < g.tf) hold[j] = src.raw(y, column_x(c));
      }
    }
  }

  __device__ __forceinline__ int column(int c) const { return c; }

  // I at walker row s*kRows + i - 2r, output column j, for q
  __device__ __forceinline__ float centre(int, int i, int j) const {
    int fs = fb + i - 2 * r;
    if (fs < 0) fs += g.lf;
    return fr[fs * g.tf + j + 2 * r + rg];
  }

  // p at row i of this step, column c: the gaussian along the row of T
  __device__ __forceinline__ float row_gauss(int i, int c) const {
    const float* t = T + i * g.tf + c + rg;
    float acc = W[rg] * t[0];
    for (int m = 1; m <= rg; ++m) acc += W[rg - m] * (t[-m] + t[m]);
    return acc;
  }

  // I from the f ring; p copied from the p ring, or (r = 1, whose leaving
  // row may be one this step takes in and has not yet put in the ring) from T
  __device__ __forceinline__ void leaving(int, int i, int, int c, int base,
                                          float& li, float& lp) const {
    const int k = 2 * r + 1;
    int fs = fb + i - k;
    if (fs < 0) fs += g.lf;
    li = fr[fs * g.tf + c + rg];
    if (i >= k) {
      lp = row_gauss(i - k, c);
    } else if constexpr (kShared) {
      lp = lpb[i * g.ti + c];
    } else {
      int ps = base + i + kRows;  // (u - k) mod kr
      if (ps >= g.kr) ps -= g.kr;
      lp = gp[ps * g.ti + c];
    }
  }

  // I from the f ring and p, the gaussian along the row of T, for all the
  // step's rows at the first (all loads before the running sums use one);
  // p into the p ring
  __device__ __forceinline__ void entering(int, int i, int, int c, int base,
                                           float& ie, float& pe) {
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        int fs = fb + j;
        if (fs >= g.lf) fs -= g.lf;
        ic[j] = fr[fs * g.tf + c + rg];
      }
      const float* t = T + c + rg;
      gauss_rows([&](int j, int d) { return t[j * g.tf + d]; }, pc);
    }
    ie = ic[i];
    pe = pc[i];
    int ps = base + i;
    if (ps >= g.kr) ps -= g.kr;
    gp[ps * g.ti + c] = pe;
  }

  // every thread: the f rows copied after the last step's stage 4 are in
  // shared memory before the column pass reads them
  __device__ __forceinline__ void before4(int, int) const {
    if constexpr (kAsync) walker::cp_async_wait_all();
  }

  // on the two warps stage 4 leaves idle (threads kStrip ..), beside it: T
  // for step s + 1, whose f rows are in the ring since before stage 4's
  // barrier, every column (off the step's critical path while stage 4 takes
  // longer than it)
  __device__ __forceinline__ void spare(int s, int steps) const {
    if (s + 1 < steps) {
      column_pass(fb + kRows - rg, threadIdx.x - kStrip, kWalkThreads - kStrip);
    }
  }

  // every thread: the new f row (a warp a row; a computed f from the held
  // loads, and the row's columns past kHold a lane (tf > 128: r > 15 or
  // wide gaussians) loaded now); then (shared-memory route) the copies of
  // the next step's leaving p rows, a warp a row, and of a float frame's new
  // f row, in two groups
  __device__ __forceinline__ void late(int s, int steps) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (!kAsync && s + 2 < steps) {
      const int y = reflect101_fast(e0 + new_row(s), h);
      float* dst = fr + new_slot() * g.tf;
#pragma unroll
      for (int j = 0; j < kHold; ++j) {
        const int c = lane + 32 * j;
        if (c < g.tf) dst[c] = src.value(hold[j], y, column_x(c));
      }
      for (int c = lane + 32 * kHold; c < g.tf; c += 32) {
        dst[c] = src.value(src.raw(y, column_x(c)), y, column_x(c));
      }
    }
    if constexpr (kShared) {
      // row `warp` of step s + 1 leaves the window: walker row (s + 1) kRows
      // + warp - k, p slot pb + 2 kRows + warp (mod kr); rows past k - 1
      // come from T
      const int u = (s + 1) * kRows + warp - (2 * r + 1);
      if (s + 1 < steps && warp < 2 * r + 1 && u >= 0) {
        int ps = pb + 2 * kRows + warp;
        while (ps >= g.kr) ps -= g.kr;
        const float* src_row = gp + ps * g.ti;
        float* dst = lpb + warp * g.ti;
        for (int c = 4 * lane; c < g.ti; c += 128) {
          walker::cp_async16(dst + c, src_row + c);
        }
      }
      walker::cp_async_commit();
      if constexpr (kAsync) {
        if (s + 2 < steps) {
          const int y = reflect101_fast(e0 + new_row(s), h);
          float* dst = fr + new_slot() * g.tf;
          for (int c = lane; c < g.tf; c += 32) {
            walker::cp_async4(dst + c, src.ptr(y, column_x(c)));
          }
        }
      }
      walker::cp_async_commit();
    }
  }

  __device__ __forceinline__ void advance() {
    fb += kRows;
    if (fb >= g.lf) fb -= g.lf;
    pb += kRows;
    if (pb >= g.kr) pb -= g.kr;
  }
};

// kShared: the workspace in shared memory, or (the scratch route) in device
// memory; either way scratch holds block_floats<kShared>(rg, r) floats a
// block. The launch bound gives each thread 96 registers (5 blocks an SM);
// the shared-memory footprint at r = 8 would allow 6 at 80 registers, which
// timed 3% slower on an NVIDIA H100 80GB HBM3 at 700.00 W.
constexpr int kTailBlocks = 5;

// Out: the output's element type, float (q) or uint8_t (q as pipeline.py's
// _to_u8 rounds it, walker.cuh's store_q)
template <class Src, bool kShared, int kRg, class Out>
__global__ void __launch_bounds__(kWalkThreads, kTailBlocks)
tail_kernel(const Src src, int h, int w, const Taps taps, int rg, int r,
            float eps, int seg_rows, float* __restrict__ scratch,
            Out* __restrict__ q) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float W[kMaxTaps];
  const walker::Workspace wl = workspace(rg, r);
  const TailGeom g(rg, r);
  const size_t block =
      (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
      blockIdx.x;
  float* slice = scratch + block * block_floats<kShared>(rg, r);
  float* ws = kShared ? smem : slice;
  for (int i = threadIdx.x; i < 2 * rg + 1; i += kWalkThreads) {
    W[i] = taps.w[i];
  }
  // p of the leaving rows after T in hab, at a 16-byte boundary
  const long long lpb = (wl.hab + static_cast<long long>(kRows) * g.tf + 3) &
                        ~3LL;
  TailRows<Src, kShared, kRg> rows{src, W, ws + wl.prod, ws + wl.hab, ws + lpb,
                              kShared ? slice : slice + wl.total, g,
                              static_cast<int>(blockIdx.y) * seg_rows - 2 * r,
                              static_cast<int>(blockIdx.x) * kStrip, h, w, r,
                              rg, 0, 0, {}, {}, {}};
  walker::walk_frame(rows, ws, wl, h, w, r, eps, seg_rows, q);
}

// The shared-memory route's bytes, or 0 when the workspace passes a block's
// shared memory (the scratch route).
inline size_t smem_bytes(int rg, int r) {
  const long long bytes = workspace(rg, r).total * 4LL;
  // the taps' static shared memory counts against the same ceiling
  return bytes + 4LL * kMaxTaps <= kMaxSmemBytes
             ? static_cast<size_t>(bytes)
             : 0;
}

inline bool bad_args(int h, int w, int rg, int r) {
  return rg < 0 || 2 * rg + 1 > kMaxTaps || r < 1 || r > kTailMaxRadius ||
         h <= 2 * r + rg || w <= 2 * r + rg;
}

// The most blocks a launch at these arguments runs: the walker's grid at the
// most blocks an SM could hold at the route's footprint (the occupancy the
// launch finds is at most that), or at the scratch route's fixed wave.
inline long long most_blocks(int h, int w, int rg, int r, long long* blocks) {
  const size_t bytes = smem_bytes(rg, r);
  long long slots = walker::kScratchSlots;
  if (bytes > 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<long long>(err);
    // 1 KB of each block's shared memory is the system's; 16 blocks of 128
    // threads fill an SM's 2048
    const long long per_block = static_cast<long long>(bytes) + 4LL * kMaxTaps +
                                1024;
    slots = static_cast<long long>(sms) *
            std::min(16LL, kSmemPerSm / per_block);
  }
  const walker::WalkGrid g = walker::walk_grid(1, h, w, r, bytes > 0, slots);
  *blocks = static_cast<long long>(g.grid.x) * g.grid.y;
  return 0;
}

// The floats of device scratch a launch at these arguments needs, -1 for
// arguments the tail refuses, or -2 - the CUDA error that stopped the count.
inline long long scratch_floats(int h, int w, int rg, int r) {
  if (bad_args(h, w, rg, r)) return -1;
  long long blocks = 0;
  const long long err = most_blocks(h, w, rg, r, &blocks);
  if (err != 0) return -2 - err;
  return blocks * (smem_bytes(rg, r) > 0 ? block_floats<true>(rg, r)
                                         : block_floats<false>(rg, r));
}

// One launch of tail_kernel<Src, kShared, kRg, Out> with the grid planned
// for it.
template <class Src, bool kShared, int kRg, class Out>
int launch_as(const Src& src, size_t bytes, int h, int w, const Taps& taps,
              int rg, int r, float eps, float* scratch, Out* out,
              cudaStream_t stream) {
  walker::WalkGrid g;
  const int err = walker::plan_walk(tail_kernel<Src, kShared, kRg, Out>,
                                    bytes, 1, h, w, r, &g);
  if (err != 0) return err;
  tail_kernel<Src, kShared, kRg, Out>
      <<<g.grid, kWalkThreads, bytes, stream>>>(src, h, w, taps, rg, r, eps,
                                                g.seg_rows, scratch, out);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the tail on an (h, w) frame; taps.w[0 .. 2*rg] are the
// gaussian weights; scratch: scratch_floats(...) floats; out: (h, w) float32
// q, or u8 (store_q). Needs h, w > 2r + rg (the callers gate on min(h, w) >
// 2*(2r + rg)). The shared-memory route at the enhance pipeline's default
// gaussian radius runs the instance with that radius fixed at compile time.
template <class Src, class Out>
int launch(const Src& src, int h, int w, const Taps& taps, int rg, int r,
           float eps, float* scratch, Out* out, cudaStream_t stream) {
  if (bad_args(h, w, rg, r) || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = smem_bytes(rg, r);
  if (bytes == 0) {
    return launch_as<Src, false, -1>(src, 0, h, w, taps, rg, r, eps,
                                     scratch, out, stream);
  }
  if (rg == kFixedRg) {
    return launch_as<Src, true, kFixedRg>(src, bytes, h, w, taps, rg, r, eps,
                                          scratch, out, stream);
  }
  return launch_as<Src, true, -1>(src, bytes, h, w, taps, rg, r, eps, scratch,
                                  out, stream);
}

}  // namespace tail
