// Guided filter on batches of float32 frames, in two forms, at two borders:
//
//   onepass: one launch. q never needs a and b in device memory.
//   twopass: the reference's gCalcAB / gWeightByABm split. Launch 1 writes
//            the per-pixel a and b to device memory, launch 2 box-sums them
//            and writes q.
//
// Reflect-101 border, 1/ksz^2 normalisation (the reference's fused
// hGuidedFilter path): both forms. Shrink border (the reference's class path,
// GuidedFilter/guided_filter.cpp:28-66 with gIntegralToMean,
// guided_filter_d.cu:241-270): twopass only (tpuimg_guided_twopass_shrink),
// a compile-time parameter of its walks. Rows and columns outside the frame
// add nothing to any window sum (of I, p, I*p and I*I, then of a and b, which
// exist only inside the frame), and each mean is its window sum over the
// window's true area cy(y) cx(x), cy(y) = min(y + r, h - 1) - max(y - r, 0)
// + 1 (cx alike), taken per pixel as the f32 reciprocal of the area; inside
// a frame's 2r-wide border that is the reflect-101 form's coef. So frames of
// any size, windows clamped at both ends included, run the same code.
//
// Replaces tpuimg/kernels/boxsum.py::guided_filter_pallas (:632): variant
// "onepass" (_guided_strip_onepass :193, pallas_calls :270 self-guided and
// :281 general) and variant "twopass" (_guided_strip :108, pallas_calls :143
// and :169); and guided_pallas_ypadded (:602; pallas_calls :592 self-guided
// and :596 general in _guided_onepass_ypadded :525), the onepass form on a
// shard's block whose rows already carry 2r halo rows on each side, (h + 4r,
// w) in and (h, w) out, x still reflect-101 in the kernel. The TPU's row
// bands, column strips of at most 2048 lanes and (8, 128) padding have no
// counterpart here.
//
// The algebra is the plain version's (tpuimg_torch/kernels/boxsum.py::
// guided_chain): the box mean of x is its window sum times coef = f32(1 /
// ksz^2); a = (mean_Ip - mean_p*mean_I) / (mean_II - mean_I^2 + eps); b =
// mean_p - a*mean_I; q = mean_a*I + mean_b, each multiply and add of a, b and
// q rounded on its own (__fmul_rn/__fadd_rn). Self-guided (p is I) keeps two
// of the four sums (mean_p = mean_I, mean_Ip = mean_II) and equals the
// general form with p = I bit for bit.
//
// Onepass, the strip walker. The function needs 12 bytes of device memory a
// pixel (I, p in, q out) and a constant number of operations, so on this card
// it is bound by bytes (0.030 ms at 4K). What held the tile kernel it replaces
// at 27x that bound was on-chip work: direct (2r + 1)-tap window sums out of
// shared memory (~340 loads a pixel at r = 8), a 32x32 tile's (32 + 4r)^2
// halo recomputed per tile, runtime divisions in its loops, and 100 KB of
// shared memory a block (2 blocks an SM; r <= 16). This design:
// - A block owns a strip of kStrip = 64 output columns over one segment of
//   rows of one frame and walks down it kRows = 4 rows a step (a warp a row),
//   so the vertical halo (4r rows) is paid once per segment and the
//   horizontal one is 4r input columns and 2r columns of a and b. Segments
//   are as many as fit one wave of the blocks the card holds at once (a
//   second, partial wave would double the time), none shorter than
//   max(kMinSegRows, 4r).
// - Window sums are running sums: an add and a subtract an element, plus a
//   2r warm-up at the start of each part of a row (at most 9 adds a column
//   at any r, 2.5 at r = 8).
//   Vertically, a thread per input column keeps the sums of I, p, I*p and
//   I*I in f64, adds the entering row and subtracts the one 2r + 1 rows above
//   (re-read from L1/L2). Products of f32 values are exact in f64 and the sums
//   drift by ~1e-16 relative down any strip, so the 2160-row walk of a 4K
//   frame is as exact as a direct sum; each row's sums are rounded to f32
//   once. Horizontally (row_window_sums), a thread runs along one part of one
//   (row, plane) pair: 2r warm-up adds, then one add and one subtract a
//   column, in f32 over 2r + ta / 8 + 2 terms at most. a and b are computed
//   once per pixel (plus the strip's side columns), in place; the second box
//   filter sums them along the rows the same way into a ring of the last
//   2r + 1 + kRows rows, then down each output column in f64. I at the output
//   pixels is kept in a ring from the step that stages it, not read again.
// - The next step's input rows come into shared memory with cp.async while
//   this step computes (two buffers); five barriers a step; no division or
//   modulo in a loop (ring slots wrap by a compare; the reflect-101 map takes
//   its modulo only on a frame narrower than the halo). Odd row strides keep
//   the threads that walk along rows side by side in distinct banks.
// - Shared memory: 18,088 + 2,320r bytes (general; self-guided 10,856 +
//   1,936r), 36,656 at r = 8: 6 blocks of 4 warps an SM, the launch bound's
//   80 registers a thread (none spilled but on the general scratch route
//   below, 80 bytes). The shared-memory route takes r <=
//   kSmemMaxRadius = 64 (166,568 bytes). Past it, the row-padded entry runs
//   the same kernel with the workspace in device memory (a per-block scratch
//   the wrapper allocates, the scratch route): input rows are read with __ldg
//   instead of staged, and any radius below kScratchMaxRadius (an input block
//   of more than 16.7 million rows) runs. The frame entry takes r <= 64.
// - What bounds it now (timed by stage on the card, PERF.md): not bytes but
//   the latency of a step's five stages, each a short chain of dependent
//   adds, run one after another between barriers; 24 warps an SM hide only
//   part of it. Overlapping the stages of successive steps is the next step.
// - Against the plain version (direct f32 sums): the same function up to the
//   order of the sums (a and b outside the frame come from the reflected
//   windows, which the reflect-101 symmetry makes equal to the plain
//   version's reflected a and b). Every running sum is repaired
//   (walker::keeps): where one is not finite, or a term more than
//   kRebuildF32 (f32) or kRebuildF64 (f64) times its magnitude has just
//   left it, sums are taken again from their windows directly. So a NaN or
//   an infinity in I or p reaches only the outputs whose windows hold it, as
//   with direct sums, and a large value leaves no residue behind; a frame
//   without them keeps the running sums' bits but where a signed sum of a
//   or b nearly cancels.
//
// The walker's body (walker.cuh) is templated on the producer of its rows
// of I and p; here GuidedRows reads them from device memory. The enhance
// tails (enhance_tail.cuh) run two walks of the twopass design below, the
// first with a producer that makes f and p on chip from the frame.
//
// Twopass, two strip walks (guided_twopass_kernel). The variant keeps a and
// b in device memory by design, so its own floor is 32 bytes a pixel (I and
// p in, a and b out; a, b and I in, q out: 0.079 ms at 4K), not the
// function's 12. What held the tile kernels it replaces at 5x that
// floor: direct (2r + 1)-tap window sums out of shared memory (~136 loads
// and adds a pixel at r = 8 in launch 1, ~68 in launch 2) and a 32x32 tile's
// (32 + 2r)^2 halo staged again for every tile (r <= 16). Each launch is now
// a walk down 128-column strips with running window sums (f64 down the
// columns, f32 along the rows by walker::row_window_sums), a halo of r
// columns and 2r rows a segment, segments sized to one wave or to a few
// (twopass_grid): launch 1 writes a and b once per pixel, launch 2
// reads them through the reflect-101 index (shrink: zero outside the frame)
// and writes q. Shared memory grows with r, not r^2: r <= kTwopassMaxRadius =
// 64. At 4K with three source channels by one guide, r 15, twopass took
// 0.9897 ms and onepass 1.3187 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
// section 6), so the shrink border runs on twopass.
#include "walker.cuh"

namespace {

using walker::ab_of;
using walker::kRebuildF64;
using walker::kRows;
using walker::kStrip;
using walker::kWalkBlocks;
using walker::kWalkThreads;
using walker::q_of;

// ---- onepass: the strip walker ---------------------------------------------

constexpr int kSmemMaxRadius = 64;       // the shared-memory route's ceiling
constexpr int kScratchMaxRadius = 1 << 22;  // keeps every index in an int

// the source row of extended row e: reflect-101 in a frame; in a row-padded
// block e + 2r (its own halo rows), clamped at its last row for the rows a
// final step reads past the segment
template <bool kYPadded>
__device__ __forceinline__ int source_row(int e, int h, int r) {
  return kYPadded ? min(e + 2 * r, h + 4 * r - 1) : reflect101_fast(e, h);
}

// The walker's producer for I and p frames in device memory: on the
// shared-memory route each step's kRows input rows of I (and p) over the
// strip's ti columns come into a double buffer with cp.async (a warp a row,
// lanes along it) while the step before computes; on the scratch route they
// are read with __ldg. The leaving rows are re-read with __ldg (L1/L2).
template <bool kSelf_, bool kYPadded, bool kShared>
struct GuidedRows {
  static constexpr bool kSelf = kSelf_;
  static constexpr bool kCentre = false;
  static constexpr bool kInRange = false;  // any float: the sums repaired
  static constexpr int ns = kSelf ? 1 : 2;  // planes staged: I, p
  const float* Iz;
  const float* pz;
  float* stg;
  int e0, x0, h, w, r, ti;

  // the floats of the staging buffers
  __host__ __device__ static long long floats(int r) {
    return kShared ? 2LL * ns * kRows * (kStrip + 4LL * r) : 0;
  }

  __device__ __forceinline__ void stage(int t) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t row =
        static_cast<size_t>(source_row<kYPadded>(e0 + t * kRows + warp, h,
                                                 r)) * w;
    float* dst = stg + static_cast<size_t>((t & 1) * ns * kRows + warp) * ti;
    for (int c = lane; c < ti; c += 32) {
      const int x = reflect101_fast(x0 - 2 * r + c, w);
      walker::cp_async4(dst + c, Iz + row + x);
      if constexpr (!kSelf) {
        walker::cp_async4(dst + kRows * ti + c, pz + row + x);
      }
    }
  }

  __device__ __forceinline__ void begin(int) const {
    if constexpr (kShared) {
      stage(0);
      walker::cp_async_commit();
    }
  }

  __device__ __forceinline__ void top(int s, int steps) const {
    if constexpr (kShared) {
      if (s + 1 < steps) stage(s + 1);
      walker::cp_async_commit();
      walker::cp_async_wait_one();
    }
  }

  __device__ __forceinline__ int column(int c) const {
    return reflect101_fast(x0 - 2 * r + c, w);
  }

  // I and p at walker row u, column x: the leaving rows, and the rows of a
  // rebuilt column sum
  __device__ __forceinline__ void row(int u, int x, float& iu,
                                      float& pu) const {
    const size_t o =
        static_cast<size_t>(source_row<kYPadded>(e0 + u, h, r)) * w + x;
    iu = __ldg(Iz + o);
    if constexpr (!kSelf) pu = __ldg(pz + o);
  }

  __device__ __forceinline__ void leaving(int u, int, int x, int, int,
                                          float& li, float& lp) const {
    row(u, x, li, lp);
  }

  __device__ __forceinline__ void entering(int s, int i, int x, int c, int,
                                           float& ie, float& pe) const {
    if constexpr (kShared) {
      const int splane = kRows * ti;  // a plane of a staging buffer
      // (s & 1) selects the buffer; a select, not a multiply, keeps the
      // row-padded general instance within its 80 registers
      const float* sI = stg + ((s & 1) ? ns * splane : 0);
      ie = sI[i * ti + c];
      pe = kSelf ? ie : sI[splane + i * ti + c];
    } else {
      const size_t o = static_cast<size_t>(source_row<kYPadded>(
                           e0 + s * kRows + i, h, r)) * w + x;
      ie = __ldg(Iz + o);
      pe = kSelf ? ie : __ldg(pz + o);
    }
  }

  __device__ __forceinline__ void before4(int, int) const {}
  __device__ __forceinline__ void spare(int, int) const {}
  __device__ __forceinline__ void late(int, int) const {}
  __device__ __forceinline__ void advance() const {}
};

template <bool kSelf, bool kYPadded, bool kShared>
walker::Workspace guided_workspace(int r) {
  return walker::workspace_of(r, kSelf,
                              GuidedRows<kSelf, kYPadded, kShared>::floats(r));
}

// kYPadded: I and p frames are (h + 4r, w) blocks whose rows are padded.
// kShared: the workspace in shared memory and input rows staged there, or
// (the scratch route) in device memory at scratch, guided_workspace(r).total
// floats a block.
template <bool kSelf, bool kYPadded, bool kShared>
__global__ void __launch_bounds__(kWalkThreads, kWalkBlocks)
guided_walk_kernel(const float* __restrict__ I, int n_i,
                   const float* __restrict__ p, int n, int h, int w, int r,
                   float eps, int seg_rows, float* __restrict__ scratch,
                   float* __restrict__ q) {
  extern __shared__ __align__(16) float smem[];
  using Rows = GuidedRows<kSelf, kYPadded, kShared>;
  const walker::Workspace wl =
      walker::workspace_of(r, kSelf, Rows::floats(r));
  float* ws = walker::block_workspace<kShared>(smem, scratch, wl.total);
  const int hin = kYPadded ? h + 4 * r : h;  // rows of a source frame
  const size_t in_plane = static_cast<size_t>(hin) * w;
  const size_t out_plane = static_cast<size_t>(h) * w;
  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    const float* Iz = I + static_cast<size_t>(z % n_i) * in_plane;
    Rows rows{Iz, kSelf ? Iz : p + static_cast<size_t>(z) * in_plane,
              ws + wl.prod, static_cast<int>(blockIdx.y) * seg_rows - 2 * r,
              static_cast<int>(blockIdx.x) * kStrip, h, w, r,
              kStrip + 4 * r};
    walker::walk_frame(rows, ws, wl, h, w, r, eps, seg_rows,
                       q + static_cast<size_t>(z) * out_plane);
    __syncthreads();  // the next frame zeroes what step 4 read
  }
}

// ---- twopass: two strip walks, a and b through device memory -----------

constexpr int kTwopassMaxRadius = 64;
constexpr int kTpThreads = 256;
constexpr int kTpStrip = 128;  // output columns of a block
constexpr int kTpRows = 8;     // rows a step takes in
// the radii whose staged rows stay in a ring for their 2r + 1 rows
constexpr int kTpRingMaxRadius = 16;
// the most waves a launch's segments are spread over (twopass_grid)
constexpr int kTpMaxWaves = 8;

// Launch 1 (kAB): inputs X = I, Y = p; window sums of I, p, I*p and I*I;
// writes a and b. Launch 2: inputs X = a, Y = b; window sums of a and b;
// writes q. kRing: the rows stay in shared memory from the step that brings
// them in until they leave the window (r <= kTpRingMaxRadius); otherwise a
// step's leaving rows are brought in again.
template <bool kAB, bool kRing>
struct Twopass {
  static constexpr int np = kAB ? 4 : 2;
  static constexpr int pairs = kTpRows * np;  // (row, plane) pairs a step
  static constexpr int parts = kTpThreads / pairs;  // of a pair's row
  static constexpr int len = kTpStrip / parts;
  static constexpr int guide = kAB ? 0 : kTpRows * kTpStrip;
  // the staged columns of a row: r rounded up to 4 on each side, so that an
  // interior row is copied 16 bytes at a time
  __host__ __device__ static int staged(int r) {
    return kTpStrip + 2 * ((r + 3) & ~3);
  }
  // the ring's rows: a window, the rows being summed and the next step's
  __host__ __device__ static int ring(int r) {
    return 2 * r + 1 + 2 * kTpRows;
  }
  // without the ring, a staging buffer: the kTpRows entering and the
  // kTpRows leaving rows of X and Y, and launch 2's guide at the step's
  // output rows
  __host__ __device__ static int buffer(int r) {
    return 4 * kTpRows * staged(r) + guide;
  }
  // the staged rows: the ring of X and Y and two of launch 2's guide rows,
  // or two staging buffers
  __host__ __device__ static int rows(int r) {
    return kRing ? 2 * ring(r) * staged(r) + 2 * guide : 2 * buffer(r);
  }
  // shared memory, in floats: the staged rows, a step's column sums rounded
  // to f32 (np x kTpRows rows of ti + 1, ti = kTpStrip + 2r) and their
  // window sums along the rows (np x kTpRows rows of kTpStrip + 1)
  __host__ __device__ static int floats(int r) {
    const int ti = kTpStrip + 2 * r;
    return rows(r) + np * kTpRows * (ti + 1) + np * kTpRows * (kTpStrip + 1);
  }
};

// A block walks a strip of kTpStrip output columns down a segment of rows
// of each frame (blockIdx.z on), kTpRows input rows a step. A step's rows
// come into shared memory by cp.async during the step before: its entering
// rows of X and Y over the strip and its r columns each side (16 bytes a
// copy where the frame's rows are 16-byte aligned and the strip is inside
// the frame, 4 bytes through the reflect-101 index elsewhere), into a ring
// that keeps them until they leave the window 2r + 1 rows later (kRing) or
// into one of two buffers with the rows that leave the window then (read
// again from L2); and in launch 2 the guide at the step's output pixels.
// Then a thread a column (ti = kTpStrip + 2r <= kTpThreads columns, so r <=
// 64) keeps f64 running sums of its planes down the column in registers
// (entering minus leaving), rounded to f32 once a row; a thread a part of a
// (row, plane) pair takes the window sums along the row
// (walker::row_window_sums); and a thread a pixel, lanes along a row, turns
// the window sums into its output: three barriers a step (running the
// three stages a step apart between single barriers measured slower: the
// doubled column and window sums leave room for two blocks an SM, not
// three). Both launches read through the reflect-101 index, so launch 2's
// window sums of a and b are the plain version's box(a), box(b). kShrink:
// both read zero outside the frame instead (a row or column there staged as
// zeros, not copied) and scale each output's sums by its own 1 / (cy cx).
// aligned: the rows of X, Y (and I) start 16-byte aligned.
template <bool kAB, bool kRing, bool kShrink>
__global__ void __launch_bounds__(kTpThreads, 3)
guided_twopass_kernel(const float* __restrict__ X, int n_x,
                      const float* __restrict__ Y,
                      const float* __restrict__ I, int n_i, int n, int h,
                      int w, int r, float eps, int seg_rows, int aligned,
                      float* __restrict__ out0, float* __restrict__ out1) {
  using T = Twopass<kAB, kRing>;
  constexpr int np = T::np, kK = kTpRows;
  constexpr int kOut = kK * kTpStrip / kTpThreads;  // outputs a thread
  extern __shared__ __align__(16) float smem[];
  const int k = 2 * r + 1, ti = kTpStrip + 2 * r;
  const int ra = (r + 3) & ~3, ts = T::staged(r), tb = T::buffer(r);
  const int m = T::ring(r);
  const int tip = ti + 1, tap = kTpStrip + 1;  // odd row strides
  // the staged rows: the ring ([X, Y][m][ts]) and two guide buffers
  // ([kK][kTpStrip]), or two buffers of [entering, leaving][X, Y][kK][ts]
  // and the guide; then the column sums and their window sums
  float* guide = smem + 2 * m * ts;
  float* vsum = smem + T::rows(r);
  float* hab = vsum + np * kK * tip;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float coef = static_cast<float>(1.0 / (static_cast<double>(k) * k));
  const int x0 = blockIdx.x * kTpStrip;
  const int y0 = blockIdx.y * seg_rows;
  const int y1 = min(y0 + seg_rows, h);
  const int e0 = y0 - r;                // extended row of walk row 0
  const int rows_in = y1 - y0 + 2 * r;  // input rows the walk takes in
  const int steps = (rows_in + kK - 1) / kK;
  const size_t plane = static_cast<size_t>(h) * w;
  const bool wide = aligned && x0 - ra >= 0 && x0 + kTpStrip + ra <= w;
  const bool wide_i = aligned && x0 + kTpStrip <= w;

  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    const float* Xz = X + static_cast<size_t>(z % n_x) * plane;
    const float* Yz = Y + static_cast<size_t>(z) * plane;
    const float* Iz = kAB ? nullptr : I + static_cast<size_t>(z % n_i) * plane;
    // walk row u of X (or Y) to dst: a warp's lanes along it
    auto row_in = [&](const float* src_plane, int u, float* dst) {
      if constexpr (kShrink) {
        if (e0 + u < 0 || e0 + u >= h) {  // outside the frame: adds nothing
          for (int c = lane; c < ts; c += 32) dst[c] = 0.0f;
          return;
        }
      }
      const float* src =
          src_plane +
          static_cast<size_t>(kShrink ? e0 + u : reflect101_fast(e0 + u, h)) *
              w;
      if (wide) {
        for (int q = lane; q < ts / 4; q += 32) {
          cp_async16(dst + 4 * q, src + x0 - ra + 4 * q);
        }
      } else if constexpr (kShrink) {
        for (int c = lane; c < ts; c += 32) {
          const int x = x0 - ra + c;
          if (x >= 0 && x < w) {
            cp_async4(dst + c, src + x);
          } else {
            dst[c] = 0.0f;
          }
        }
      } else {
        for (int c = lane; c < ts; c += 32) {
          cp_async4(dst + c, src + reflect101_fast(x0 - ra + c, w));
        }
      }
    };
    // the rows of step t (ring slots from `base`, or buffer t & 1) and
    // launch 2's guide (buffer t & 1): a warp a row
    auto stage_in = [&](int t, int base) {
      if constexpr (kRing) {
        for (int j = warp; j < 2 * kK; j += kTpThreads / 32) {
          const int i = j % kK;
          int slot = base + i;
          if (slot >= m) slot -= m;
          row_in(j < kK ? Xz : Yz, t * kK + i,
                 smem + ((j < kK ? 0 : m) + slot) * ts);
        }
      } else {
        float* buf = smem + (t & 1) * tb;
        for (int j = warp; j < 4 * kK; j += kTpThreads / 32) {
          const int i = j % kK, leaving = j / (2 * kK);
          const int u = t * kK + i - (leaving ? k : 0);
          if (u < 0) continue;  // before the walk: stage 1 takes 0
          row_in((j / kK) & 1 ? Yz : Xz, u, buf + j * ts);
        }
      }
      if constexpr (!kAB) {
        float* gbuf = (kRing ? guide + (t & 1) * T::guide
                             : smem + (t & 1) * tb + 4 * kK * ts);
        for (int i = warp; i < kK; i += kTpThreads / 32) {
          const int y = y0 + t * kK + i - 2 * r;
          if (y < y0 || y >= y1) continue;
          const float* src = Iz + static_cast<size_t>(y) * w + x0;
          float* dst = gbuf + i * kTpStrip;
          if (wide_i) {
            cp_async16(dst + 4 * lane, src + 4 * lane);
          } else {
            for (int c = lane; c < kTpStrip && x0 + c < w; c += 32) {
              cp_async4(dst + c, src + c);
            }
          }
        }
      }
      cp_async_commit();
    };
    double v[np];  // column tid's running sums
#pragma unroll
    for (int pl = 0; pl < np; ++pl) v[pl] = 0.0;
    int base = 0;  // the ring slot of this step's first row
    stage_in(0, 0);
    for (int s = 0; s < steps; ++s) {
      cp_async_wait_all();
      __syncthreads();
      // the next step's rows, over what the step before read (stages 1 and
      // 3) ahead of this barrier
      int next = base + kK;
      if (next >= m) next -= m;
      if (s + 1 < steps) stage_in(s + 1, next);

      // 1. running sums down each input column: after walk row u the sums
      //    cover rows u - 2r .. u (centre u - r)
      if (tid < ti) {
        const float* in = smem + tid + ra - r;
        const float* buf = in + (s & 1) * tb;
        bool kept = true;  // every row's sums kept (the repair)
#pragma unroll
        for (int i = 0; i < kK; ++i) {
          const float *ex, *ey, *lx, *ly;  // entering and leaving X and Y
          if constexpr (kRing) {
            int slot = base + i;
            if (slot >= m) slot -= m;
            int old = slot - k;
            if (old < 0) old += m;
            ex = in + slot * ts;
            ey = in + (m + slot) * ts;
            lx = in + old * ts;
            ly = in + (m + old) * ts;
          } else {
            ex = buf + i * ts;
            ey = buf + (kK + i) * ts;
            lx = buf + (2 * kK + i) * ts;
            ly = buf + (3 * kK + i) * ts;
          }
          // f32 values and their products are exact in f64
          const bool full = s * kK + i >= k;  // a row leaves the window
          const double dx = *ex, dy = *ey;
          const float flx = full ? *lx : 0.0f, fly = full ? *ly : 0.0f;
          const double dlx = flx, dly = fly;
          v[0] += dx - dlx;
          v[1] += dy - dly;
          if constexpr (kAB) {
            v[2] += dx * dy - dlx * dly;
            v[3] += dx * dx - dlx * dlx;
          }
          float f[np];
#pragma unroll
          for (int pl = 0; pl < np; ++pl) {
            f[pl] = static_cast<float>(v[pl]);
            vsum[(pl * kK + i) * tip + tid] = f[pl];
          }
          // the repair (walker::keeps), checked on the planes of Y and of
          // X*X (launch 1) or of X and Y (launch 2)
          kept &= walker::keeps(fly, f[1], kRebuildF64) &
                  (kAB ? walker::keeps(flx * flx, f[3], kRebuildF64)
                       : walker::keeps(flx, f[0], kRebuildF64));
        }
        // a step with a sum that failed: every row's sums of this column
        // summed again directly, its window read again from device memory,
        // oldest row first
        if (!kept) {
          const int x =
              kShrink ? x0 - r + tid : reflect101_fast(x0 - r + tid, w);
#pragma unroll 1
          for (int i = 0; i < kK; ++i) {
            const int u = s * kK + i;
#pragma unroll
            for (int pl = 0; pl < np; ++pl) v[pl] = 0.0;
#pragma unroll 1
            for (int t = max(0, u - 2 * r); t <= u; ++t) {
              if constexpr (kShrink) {  // rows and columns outside add 0
                if (e0 + t < 0 || e0 + t >= h || x < 0 || x >= w) continue;
              }
              const size_t o =
                  static_cast<size_t>(kShrink ? e0 + t
                                              : reflect101_fast(e0 + t, h)) *
                      w +
                  x;
              const double tx = __ldg(Xz + o), ty = __ldg(Yz + o);
              v[0] += tx;
              v[1] += ty;
              if constexpr (kAB) {
                v[2] += tx * ty;
                v[3] += tx * tx;
              }
            }
#pragma unroll
            for (int pl = 0; pl < np; ++pl) {
              vsum[(pl * kK + i) * tip + tid] = static_cast<float>(v[pl]);
            }
          }
        }
      }
      __syncthreads();

      // 2. window sums along the rows whose column window is full
      {
        const int m2 = tid % T::pairs, part = tid / T::pairs;  // pl*kK + i
        const int u = s * kK + m2 % kK;
        if (u >= 2 * r && u < rows_in) {
          walker::row_window_sums<true>(vsum + m2 * tip, part * T::len,
                                        (part + 1) * T::len, r,
                                        hab + m2 * tap);
        }
      }
      __syncthreads();

      // 3. the outputs: a warp along a row of the strip
      const float* gbuf = kRing ? guide + (s & 1) * T::guide
                                : smem + (s & 1) * tb + 4 * kK * ts;
#pragma unroll
      for (int e = 0; e < kOut; ++e) {
        const int pix = tid + e * kTpThreads;
        const int i = pix / kTpStrip, j = pix % kTpStrip;
        const int u = s * kK + i, y = y0 + u - 2 * r, x = x0 + j;
        if (u < 2 * r || y >= y1 || x >= w) continue;
        const size_t o = static_cast<size_t>(z) * plane +
                         static_cast<size_t>(y) * w + x;
        const float* sums = hab + i * tap + j;  // plane pl at pl * kK * tap
        float cf = coef;
        if constexpr (kShrink) {  // 1 / the window's area inside the frame
          const int cy = min(y + r, h - 1) - max(y - r, 0) + 1;
          const int cx = min(x + r, w - 1) - max(x - r, 0) + 1;
          cf = __frcp_rn(static_cast<float>(cy * cx));
        }
        if constexpr (kAB) {
          float a, b;
          ab_of(sums[0], sums[kK * tap], sums[2 * kK * tap],
                sums[3 * kK * tap], cf, eps, &a, &b);
          out0[o] = a;
          out1[o] = b;
        } else {
          out0[o] = q_of(sums[0], sums[kK * tap], gbuf[pix], cf);
        }
      }
      base = next;
    }
    __syncthreads();  // the next frame stages over this one's rows
  }
}

bool bad_frames(int n_i, int n, int h, int w) {
  return n_i < 1 || n < 1 || n % n_i != 0 || h < 1 || w < 1;
}

// A launch's grid: walker::strip_grid's segments for one wave of `slots`
// blocks or for a few, whichever walks the fewest rows a slot. A block's
// time goes with the rows it walks, its segment's and the 2r above them, so
// w waves of segments cost w (seg_rows + 2r) a frame. One wave leaves slots
// empty where the walks do not divide them: at 4K r 15 by three planes it
// holds 2 segments a plane, 180 blocks of 264 (1,110 rows a slot), and three
// waves hold 8, 720 blocks (900 rows). There the call took 0.81 ms against
// 1.06 (launch 1 0.41 against 0.54, launch 2 0.39 against 0.52) and three
// one-plane calls 0.87, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
// section 6).
walker::WalkGrid twopass_grid(int n, int h, int w, int r, long long slots) {
  walker::WalkGrid best{};
  long long least = 0;
  for (int waves = 1; waves <= kTpMaxWaves; ++waves) {
    const walker::WalkGrid g = walker::strip_grid(n, h, w, kTpStrip, 2 * r,
                                                  65535, waves * slots);
    const long long blocks =
        static_cast<long long>(g.grid.x) * g.grid.y * g.grid.z;
    const long long rows = (blocks + slots - 1) / slots *
                           ((n + g.grid.z - 1) / g.grid.z) *
                           (g.seg_rows + 2 * r);
    if (waves == 1 || rows < least) {
      best = g;
      least = rows;
    }
  }
  return best;
}

template <bool kAB, bool kRing, bool kShrink>
int launch_twopass_as(const float* X, int n_x, const float* Y,
                      const float* I, int n_i, int n, int h, int w, int r,
                      float eps, float* out0, float* out1,
                      cudaStream_t stream) {
  auto kernel = guided_twopass_kernel<kAB, kRing, kShrink>;
  const size_t bytes =
      static_cast<size_t>(Twopass<kAB, kRing>::floats(r)) * sizeof(float);
  long long slots = 0;
  const int err = walker::wave_slots(kernel, kTpThreads, bytes, &slots);
  if (err != 0) return err;
  const walker::WalkGrid g = twopass_grid(n, h, w, r, slots);
  auto a16 = [](const float* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const int aligned =
      w % 4 == 0 && a16(X) && a16(Y) && (I == nullptr || a16(I));
  kernel<<<g.grid, kTpThreads, bytes, stream>>>(X, n_x, Y, I, n_i, n, h, w,
                                                r, eps, g.seg_rows, aligned,
                                                out0, out1);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAB, bool kShrink>
int launch_twopass(const float* X, int n_x, const float* Y, const float* I,
                   int n_i, int n, int h, int w, int r, float eps,
                   float* out0, float* out1, cudaStream_t stream) {
  return r <= kTpRingMaxRadius
             ? launch_twopass_as<kAB, true, kShrink>(X, n_x, Y, I, n_i, n, h,
                                                     w, r, eps, out0, out1,
                                                     stream)
             : launch_twopass_as<kAB, false, kShrink>(X, n_x, Y, I, n_i, n, h,
                                                      w, r, eps, out0, out1,
                                                      stream);
}

// Both launches of a twopass call, a and b through device memory.
template <bool kShrink>
int twopass(const float* I, int n_i, const float* p, int n, int h, int w,
            int r, float eps, float* a, float* b, float* q,
            cudaStream_t stream) {
  if (bad_frames(n_i, n, h, w) || r < 1 || r > kTwopassMaxRadius) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = launch_twopass<true, kShrink>(I, n_i, p, nullptr, 1, n, h,
                                                w, r, eps, a, b, stream);
  if (err != 0) return err;
  return launch_twopass<false, kShrink>(a, n, b, I, n_i, n, h, w, r, eps, q,
                                        nullptr, stream);
}

// ---- launches --------------------------------------------------------------

template <bool kSelf, bool kYPadded, bool kShared>
int launch_walk(const float* I, int n_i, const float* p, int n, int h, int w,
                int r, float eps, float* scratch, float* q,
                cudaStream_t stream) {
  auto kernel = guided_walk_kernel<kSelf, kYPadded, kShared>;
  const size_t bytes =
      kShared ? static_cast<size_t>(
                    guided_workspace<kSelf, kYPadded, true>(r).total) *
                    sizeof(float)
              : 0;
  walker::WalkGrid g;
  const int err = walker::plan_walk(kernel, bytes, n, h, w, r, &g);
  if (err != 0) return err;
  kernel<<<g.grid, kWalkThreads, bytes, stream>>>(I, n_i, p, n, h, w, r, eps,
                                                  g.seg_rows, scratch, q);
  return static_cast<int>(cudaGetLastError());
}

template <bool kYPadded, bool kShared>
int onepass(const float* I, int n_i, const float* p, int n, int h, int w,
            int r, float eps, int self_guided, float* scratch, float* q,
            cudaStream_t stream) {
  const int most = kShared ? kSmemMaxRadius : kScratchMaxRadius;
  if (bad_frames(n_i, n, h, w) || r < 1 || r > most ||
      (self_guided && n != n_i) || (!kShared && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return self_guided
             ? launch_walk<true, kYPadded, kShared>(I, n_i, I, n, h, w, r, eps,
                                                    scratch, q, stream)
             : launch_walk<false, kYPadded, kShared>(I, n_i, p, n, h, w, r,
                                                     eps, scratch, q, stream);
}

}  // namespace

// I: n_i frames of (h, w) float32; p, q: n frames, n a multiple of n_i, and
// p frame z is guided by I frame z mod n_i. self_guided: p is I (p unused,
// n == n_i). All contiguous. r <= 64.
extern "C" int tpuimg_guided_onepass(const float* I, int n_i, const float* p,
                                     int n, int h, int w, int r, float eps,
                                     int self_guided, float* q,
                                     cudaStream_t stream) {
  return onepass<false, true>(I, n_i, p, n, h, w, r, eps, self_guided,
                              nullptr, q, stream);
}

// As tpuimg_guided_onepass, with I and p frames of (h + 4r, w): rows padded
// by 2r on each side; q is (h, w) frames. r <= 64 (shared memory).
extern "C" int tpuimg_guided_onepass_ypadded(const float* I, int n_i,
                                             const float* p, int n, int h,
                                             int w, int r, float eps,
                                             int self_guided, float* q,
                                             cudaStream_t stream) {
  return onepass<true, true>(I, n_i, p, n, h, w, r, eps, self_guided, nullptr,
                             q, stream);
}

// The floats of device scratch tpuimg_guided_onepass_ypadded_scratch needs
// for this call, or -1 for arguments it refuses.
extern "C" long long tpuimg_guided_onepass_scratch_floats(int n, int h, int w,
                                                          int r,
                                                          int self_guided) {
  if (n < 1 || h < 1 || w < 1 || r < 1 || r > kScratchMaxRadius) return -1;
  const walker::WalkGrid g =
      walker::walk_grid(n, h, w, r, false, walker::kScratchSlots);
  const long long total =
      self_guided ? guided_workspace<true, true, false>(r).total
                  : guided_workspace<false, true, false>(r).total;
  return total * g.grid.x * g.grid.y * g.grid.z;
}

// As tpuimg_guided_onepass_ypadded at any r < 2^22, the walker's workspace
// in scratch (tpuimg_guided_onepass_scratch_floats floats).
extern "C" int tpuimg_guided_onepass_ypadded_scratch(
    const float* I, int n_i, const float* p, int n, int h, int w, int r,
    float eps, int self_guided, float* scratch, float* q,
    cudaStream_t stream) {
  return onepass<true, false>(I, n_i, p, n, h, w, r, eps, self_guided,
                              scratch, q, stream);
}

// As tpuimg_guided_onepass, general only, r <= 64; a, b: n frames of
// scratch, written by launch 1 and read by launch 2.
extern "C" int tpuimg_guided_twopass(const float* I, int n_i, const float* p,
                                     int n, int h, int w, int r, float eps,
                                     float* a, float* b, float* q,
                                     cudaStream_t stream) {
  return twopass<false>(I, n_i, p, n, h, w, r, eps, a, b, q, stream);
}

// As tpuimg_guided_twopass at the shrink border: windows clamped to the
// frame, each mean over its true area.
extern "C" int tpuimg_guided_twopass_shrink(const float* I, int n_i,
                                            const float* p, int n, int h,
                                            int w, int r, float eps, float* a,
                                            float* b, float* q,
                                            cudaStream_t stream) {
  return twopass<true>(I, n_i, p, n, h, w, r, eps, a, b, q, stream);
}
