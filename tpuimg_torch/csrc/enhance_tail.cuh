// The enhance pipeline's tail: q = guided(I=f, p=gaussian(f, rg), r, eps),
// reflect-101 borders, 1/ksz^2 normalisation, in two launches of one C call,
// templated on the producer of f. enhance_tail.cu reads f from a float32
// frame; enhance_tail_clahe.cu computes it from the u8 frame through the
// CLAHE blend. Both instantiate this one body, so their tail arithmetic is
// the same code.
//
// The algebra is tpuimg/kernels/boxsum.py::_tail_chain's: on the frame
// extended by reflect-101, smooth f with the separable gaussian (down the
// columns, then along the rows, each in the symmetric form w[rg]*c +
// sum w[rg - m]*(left + right)), take the four box sums of I = f, p, I*p and
// I*I, form a and b, box-sum them and emit q. The smoothed frame never
// reaches device memory; a and b do.
//
// Design on this card: two strip walks of guided.cu's twopass design
// (guided_twopass_kernel), the first with a producer that makes f and p on
// chip. The onepass walker (walker.cuh) that the tail ran on before takes a
// 64-column strip 4 rows a step on 128 threads through five dependent stages
// between barriers, and that chain of latencies, not bytes, set its time
// (0.2931 ms at 4K, 1.1485 ms at 8K, about 4% of the tail's byte bound).
// The twopass walks take 128-column strips 8 rows a step on 256 threads with
// three barriers a step, so each step's barriers, row warm-ups and halo
// columns are paid over 4x the pixels; on the card twopass's two walks beat
// the onepass walker by 29% on the guided filter alone, writing a and b to
// device memory and reading them back.
// - Walk 1 (kAB): a block walks a strip of kTpStrip = 128 output columns
//   down one segment of rows, kTpRows = 8 rows a step. f is made once per
//   pixel of the strip and its halo (128 + 2 round4(r + rg) columns,
//   reflect-101 mapped) two steps ahead, into a ring of f rows in shared
//   memory: a float frame's rows by cp.async (16 bytes a copy where the rows
//   are aligned and the strip is inside the frame), the CLAHE blend's from
//   loads issued at the top of a step and turned into f in its last stage.
//   The gaussian's column pass for the next step's rows runs in the last
//   stage (T), its row pass in stage 1, a thread a column, for all 8 rows
//   before the running sums take the first; the enhance default rg = 2 runs
//   an instance with its tap loops unrolled at compile time. Stage 1 keeps
//   f64 running sums of I, p, I*p and I*I down each of the 128 + 2r columns
//   (entering minus leaving), stage 2 takes the f32 window sums along the
//   rows (walker::row_window_sums; f and p lie in [0, 1], so the repair is
//   compiled out), stage 3 turns them into a and b (walker::ab_of) and
//   writes both as f32 planes of the scratch (rows padded to 4 floats).
// - The leaving rows: I comes from the f ring, which reaches 2r + 1 rows
//   back; p from a ring of the last 2r + 1 rows of p in shared memory, each
//   thread reading its column's leaving row before it writes the entering
//   one into the same slot. The p ring takes (2r + 1)(128 + 2r) floats,
//   9,792 bytes of walk 1's 75,744 at r = 8, rg = 2 (3 blocks an SM). Of
//   the other places for p, a ring in device memory costs two L2 round
//   trips a step (the whole call 0.3864 ms at 4K against 0.2008, walk 1's
//   scratch route forced to r = 8), and recomputing it would run the
//   gaussian again over the leaving rows' 2r + 1 + 2rg f rows, twice its
//   work, with those rows kept in the f ring. Where the rings pass a block's
//   shared memory (r > 44 at rg <= 2, r > 39 at rg = 16), the scratch route
//   keeps I and p of the leaving rows in a per-block ring of the device
//   scratch instead (2 (2r + 1)(128 + 2r) floats a block), and the f ring
//   only the gaussian's rows.
// - Walk 2 (!kAB): twopass's launch 2: window sums of a and b through the
//   reflect-101 index (rows staged by cp.async into a ring up to r = 16, or
//   entering and leaving rows into two buffers), I at the output pixels read
//   at the top of the step (the f32 frame, or the CLAHE blend computed from
//   the u8 frame) and q stored by walker::store_q: u8 on enhance's path.
// Arithmetic: f32 a, b and q, f64 column sums, ab_of and q_of with every
// multiply and add rounded on its own, the 1/ksz^2 coefficient; only the
// order of the f32 sums along the rows differs from the onepass walker's.
// Bound: f read twice (8 bytes a pixel as float32), a and b written and read
// (16), q written (1 as u8): about 25 bytes a pixel, 0.062 ms at 4K; the
// function itself needs 5 (f32 f, u8 q). gf r <= kTailMaxRadius = 64 (a
// thread a column in stage 1: 128 + 2r <= 256), rg <= 16 (kMaxTaps).
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W, r = 8, rg = 2, u8 q,
// median of 30 events, against the onepass walker in the same call: 4K
// 0.2045 ms (walk 1 0.1158, walk 2 0.0866 alone) against 0.2965, 8K 0.7885
// against 1.1508; fused1 0.2744 and 1.0722 against 0.3691 and 1.4234
// (PERF.md §6).
#pragma once

#include "enhance_plan.cuh"
#include "walker.cuh"

constexpr int kTailMaxRadius = 64;  // 128 + 2r columns, a thread each
// the enhance pipeline's default gaussian radius, which walk 1 runs with its
// tap loops unrolled at compile time
constexpr int kFixedRg = 2;

namespace tail {

constexpr int kTpThreads = 256;
constexpr int kTpStrip = 128;  // output columns of a block
constexpr int kTpRows = 8;     // rows a step takes in: a warp each
// the launch bounds: walk 1, 3 blocks an SM (80 registers a thread; its
// shared memory at r = 8 holds 3), walk 2, 4 (64 registers), which timed 4%
// under 3 on an NVIDIA H100 80GB HBM3 at 700.00 W (0.0864 against 0.0898 ms
// at 4K)
constexpr int kAbBlocks = 3;
constexpr int kQBlocks = 4;
// walk 2 keeps its staged rows of a and b for their 2r + 1 rows up to here
constexpr int kTpRingMaxRadius = 16;
// walk 1's scratch route plans its grid, and sizes its rings, for this many
// resident blocks (2 an SM of an H100), so the scratch is known before the
// launch
constexpr long long kScratchSlots = 2 * 132LL;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Walk 1's shared layout in floats: the f ring (lf rows of ts columns from
// x0 - fa), T (the gaussian's column pass for a step: kTpRows rows of tf),
// the p ring (kRing: k rows of ti), the step's column sums rounded to f32 (4
// planes of kTpRows rows of ti + 1) and their window sums along the rows (4
// planes of kTpRows rows of kTpStrip + 1). The f ring holds, during step s,
// walk rows from s*kTpRows - k (leaving I; kRing) or from the gaussian's
// first row to the rows copied for step s + 2.
struct AbGeom {
  int k, ti, tf, fa, ts, lf;
  long long t, pr, vsum, hab, total;
  __host__ __device__ AbGeom(int rg, int r, bool ring)
      : k(2 * r + 1),
        ti(kTpStrip + 2 * r),
        tf(kTpStrip + 2 * r + 2 * rg),
        fa(round4(r + rg)),
        ts(kTpStrip + 2 * round4(r + rg)),
        lf(3 * kTpRows + rg +
           (ring ? (2 * r + 1 > rg - kTpRows ? 2 * r + 1 : rg - kTpRows)
                 : (rg > kTpRows ? rg - kTpRows : 0))) {
    t = static_cast<long long>(lf) * ts;
    pr = t + static_cast<long long>(kTpRows) * tf;
    vsum = pr + (ring ? static_cast<long long>(k) * ti : 0);
    hab = vsum + 4LL * kTpRows * (ti + 1);
    total = hab + 4LL * kTpRows * (kTpStrip + 1);
  }
};

// Walk 2's shared layout in floats: the staged rows of a and b (a ring of
// 2r + 1 + 2 kTpRows rows of each, or two buffers of the entering and
// leaving rows of each), then the step's column sums and their window sums.
struct QGeom {
  int ra, ts, m;
  long long vsum, hab, total;
  __host__ __device__ QGeom(int r, bool ring)
      : ra(round4(r)), ts(kTpStrip + 2 * round4(r)), m(2 * r + 1 + 2 * kTpRows) {
    vsum = ring ? 2LL * m * ts : 2LL * 4 * kTpRows * ts;
    hab = vsum + 2LL * kTpRows * (kTpStrip + 2 * r + 1);
    total = hab + 2LL * kTpRows * (kTpStrip + 1);
  }
};

// Both walks' arguments: the a and b planes (h rows of wp = round4(w)
// floats) and, on walk 1's scratch route, the per-block rings after them.
struct TailArgs {
  Taps taps;
  float* a;
  float* b;
  float* ring;
  int h, w, wp, rg, r, seg_rows, aligned;
  float eps;
};

// acc[i] = W[rg] x_i(0) + sum over m = 1 .. rg of W[rg - m] (x_i(-m) +
// x_i(m)), in that order (the plain version's), for the kTpRows rows i at
// once, x_i(d) = at(i, d): the taps outer, so that a tap's loads for every
// row are in flight together; with rg fixed at compile time (kRg >= 0)
// every load of every tap
template <int kRg, class At>
__device__ __forceinline__ void gauss_rows(const float* W, int rg, At at,
                                           float* acc) {
  const int n = kRg >= 0 ? kRg : rg;
#pragma unroll
  for (int i = 0; i < kTpRows; ++i) acc[i] = W[n] * at(i, 0);
#pragma unroll
  for (int m = 1; m <= n; ++m) {
    const float wm = W[n - m];
#pragma unroll
    for (int i = 0; i < kTpRows; ++i) acc[i] += wm * (at(i, -m) + at(i, m));
  }
}

// Walk 1: a and b of the block's strip (blockIdx.x) over its segment
// (blockIdx.y). Walk row u is extended row y0 - r + u; after row u a
// column's sums cover rows u - 2r .. u, the window of output row
// y0 + u - 2r. kRing: the leaving rows' I and p in shared memory, else in
// the block's ring of the device scratch. kRg: rg fixed at compile time,
// or -1.
template <class Src, bool kRing, int kRg>
__device__ __forceinline__ void walk_ab(const Src& src, const TailArgs& g,
                                        float* smem) {
  constexpr int kK = kTpRows;
  constexpr int kHold = 4;  // loads a lane holds: a row's first 128 columns
  using Raw = typename Src::Raw;
  __shared__ float W[kMaxTaps];
  const int h = g.h, w = g.w, r = g.r, rg = g.rg;
  const AbGeom geo(rg, r, kRing);
  const int k = geo.k, ti = geo.ti, tf = geo.tf, fa = geo.fa, ts = geo.ts;
  const int lf = geo.lf;
  float* fr = smem;
  float* T = smem + geo.t;
  float* pr = smem + geo.pr;
  float* vsum = smem + geo.vsum;
  float* hab = smem + geo.hab;
  const int tip = ti + 1, tap = kTpStrip + 1;  // odd row strides
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float coef = static_cast<float>(1.0 / (static_cast<double>(k) * k));
  const int x0 = blockIdx.x * kTpStrip;
  const int y0 = blockIdx.y * g.seg_rows;
  const int y1 = min(y0 + g.seg_rows, h);
  const int e0 = y0 - r;                // extended row of walk row 0
  const int rows_in = y1 - y0 + 2 * r;  // rows the walk takes in
  const int steps = (rows_in + kK - 1) / kK;
  const bool wide = g.aligned && x0 - fa >= 0 && x0 + kTpStrip + fa <= w;
  // the block's ring of I and p in the device scratch (k rows of ti each)
  float* gr = kRing ? nullptr
                    : g.ring + (static_cast<size_t>(blockIdx.y) * gridDim.x +
                                blockIdx.x) * 2 * k * ti;
  for (int i = tid; i < 2 * rg + 1; i += kTpThreads) W[i] = g.taps.w[i];

  auto column_x = [&](int c) { return reflect101_fast(x0 - fa + c, w); };
  // f of walk row t into f slot `slot`, a warp's lanes along the row: a
  // float frame's by cp.async, a computed f with all of a lane's loads
  // issued before the first store
  auto fill = [&](int t, int slot) {
    const int y = reflect101_fast(e0 + t, h);
    float* dst = fr + slot * ts;
    if constexpr (Src::kAsync) {
      if (wide) {
        for (int q = lane; q < ts / 4; q += 32) {
          walker::cp_async16(dst + 4 * q, src.ptr(y, x0 - fa + 4 * q));
        }
      } else {
        for (int c = lane; c < ts; c += 32) {
          walker::cp_async4(dst + c, src.ptr(y, column_x(c)));
        }
      }
    } else {
      for (int c0 = lane; c0 < ts; c0 += 32 * kHold) {
        Raw v[kHold];
#pragma unroll
        for (int j = 0; j < kHold; ++j) {
          const int c = c0 + 32 * j;
          if (c < ts) v[j] = src.raw(y, column_x(c));
        }
#pragma unroll
        for (int j = 0; j < kHold; ++j) {
          const int c = c0 + 32 * j;
          if (c < ts) dst[c] = src.value(v[j], y, column_x(c));
        }
      }
    }
  };
  // T = the gaussian down the columns for the step whose first walk row is
  // in f slot fb: tf columns from ring column fa - r - rg
  auto column_pass = [&](int fb) {
    int f0 = fb - rg;
    if (f0 < 0) f0 += lf;
    const int off = fa - r - rg;
    for (int c = tid; c < tf; c += kTpThreads) {
      float acc[kK];
      gauss_rows<kRg>(
          W, rg,
          [&](int i, int d) {
            int sc = f0 + i + rg + d;  // in [0, 2 lf)
            if (sc >= lf) sc -= lf;
            return fr[sc * ts + c + off];
          },
          acc);
#pragma unroll
      for (int i = 0; i < kK; ++i) T[i * tf + c] = acc[i];
    }
  };

  // walk rows -rg .. 2 kK - 1 + rg (the first two steps' gaussians) in f
  // slots 0 ..: walk row t in slot (t + rg) mod lf; then T of step 0
  for (int j = warp; j < 2 * kK + 2 * rg; j += kTpThreads / 32) {
    fill(j - rg, j);
  }
  walker::cp_async_commit();
  walker::cp_async_wait_all();
  __syncthreads();
  column_pass(rg);

  double v[4] = {0.0, 0.0, 0.0, 0.0};  // column tid's running sums
  int fb = rg;  // f slot of the step's first walk row
  int pb = 0;   // p ring slot of the step's first walk row: row u at u mod k
  Raw hold[kHold];
  for (int s = 0; s < steps; ++s) {
    walker::cp_async_wait_all();
    __syncthreads();
    // step s + 2's new f rows, a warp each, into the slots of rows the walk
    // has left: copies now, or (computed f) loads now and f in stage 3
    const bool ahead = s + 2 < steps;
    int nslot = fb + 2 * kK + rg + warp;
    while (nslot >= lf) nslot -= lf;
    const int nrow = (s + 2) * kK + rg + warp;
    if (ahead) {
      if constexpr (Src::kAsync) {
        fill(nrow, nslot);
      } else {
        const int y = reflect101_fast(e0 + nrow, h);
#pragma unroll
        for (int j = 0; j < kHold; ++j) {
          const int c = lane + 32 * j;
          if (c < ts) hold[j] = src.raw(y, column_x(c));
        }
      }
    }
    walker::cp_async_commit();

    // 1. I from the f ring and p, the gaussian along T's rows, for all the
    //    step's rows; the leaving rows' I and p; running sums down each of
    //    the ti columns
    if (tid < ti) {
      const int c = tid;
      float ie[kK], pe[kK];
#pragma unroll
      for (int i = 0; i < kK; ++i) {
        int fs = fb + i;
        if (fs >= lf) fs -= lf;
        ie[i] = fr[fs * ts + c + fa - r];
      }
      gauss_rows<kRg>(
          W, rg, [&](int i, int d) { return T[i * tf + c + rg + d]; }, pe);
#pragma unroll
      for (int i = 0; i < kK; ++i) {
        const int u = s * kK + i;
        const bool full = u >= k;  // a row leaves the window
        int ps = pb + i;  // (u - k) mod k = u mod k
        while (ps >= k) ps -= k;
        float li, lp;
        if constexpr (kRing) {
          int fs = fb + i - k;  // in (-lf, lf + kK)
          if (fs < 0) fs += lf;
          if (fs >= lf) fs -= lf;
          li = full ? fr[fs * ts + c + fa - r] : 0.0f;
          lp = full ? pr[ps * ti + c] : 0.0f;
          pr[ps * ti + c] = pe[i];
        } else {
          float* gi = gr + ps * ti + c;
          float* gp = gi + k * ti;
          li = full ? *gi : 0.0f;
          lp = full ? *gp : 0.0f;
          *gi = ie[i];
          *gp = pe[i];
        }
        // f32 values and their products are exact in f64
        const double di = ie[i], dp = pe[i], dl = li, dq = lp;
        v[0] += di - dl;
        v[1] += dp - dq;
        v[2] += di * dp - dl * dq;
        v[3] += di * di - dl * dl;
#pragma unroll
        for (int pl = 0; pl < 4; ++pl) {
          vsum[(pl * kK + i) * tip + c] = static_cast<float>(v[pl]);
        }
      }
    }
    __syncthreads();

    // 2. window sums along the rows whose column window is full: a thread a
    //    16-column part of a (plane, row) pair
    {
      constexpr int pairs = 4 * kK, len = kTpStrip / (kTpThreads / pairs);
      const int m2 = tid % pairs, part = tid / pairs;  // m2 = plane*kK + row
      const int u = s * kK + m2 % kK;
      if (u >= 2 * r && u < rows_in) {
        walker::row_window_sums<false>(vsum + m2 * tip, part * len,
                                       (part + 1) * len, r, hab + m2 * tap);
      }
    }
    __syncthreads();

    // 3. a and b, a warp along a row of the strip; T for the next step; the
    //    computed f of step s + 2's new rows
#pragma unroll
    for (int e = 0; e < kK * kTpStrip / kTpThreads; ++e) {
      const int pix = tid + e * kTpThreads;
      const int i = pix / kTpStrip, j = pix % kTpStrip;
      const int u = s * kK + i, y = y0 + u - 2 * r, x = x0 + j;
      if (u < 2 * r || y >= y1 || x >= w) continue;
      const float* sums = hab + i * tap + j;  // plane pl at pl * kK * tap
      float a, b;
      walker::ab_of(sums[0], sums[kK * tap], sums[2 * kK * tap],
                    sums[3 * kK * tap], coef, g.eps, &a, &b);
      const size_t o = static_cast<size_t>(y) * g.wp + x;
      g.a[o] = a;
      g.b[o] = b;
    }
    int nb = fb + kK;
    if (nb >= lf) nb -= lf;
    if (s + 1 < steps) column_pass(nb);
    if constexpr (!Src::kAsync) {
      if (ahead) {
        const int y = reflect101_fast(e0 + nrow, h);
        float* dst = fr + nslot * ts;
#pragma unroll
        for (int j = 0; j < kHold; ++j) {
          const int c = lane + 32 * j;
          if (c < ts) dst[c] = src.value(hold[j], y, column_x(c));
        }
        for (int c = lane + 32 * kHold; c < ts; c += 32) {
          dst[c] = src.value(src.raw(y, column_x(c)), y, column_x(c));
        }
      }
    }
    fb = nb;
    pb += kK;
    while (pb >= k) pb -= k;
  }
}

// Walk 2: q of the block's strip over its segment from the window sums of a
// and b (guided.cu's twopass launch 2, without the repair: a and b of f in
// [0, 1]). kRing: the staged rows stay in a ring for their 2r + 1 rows (r <=
// kTpRingMaxRadius), else a step's leaving rows are staged again.
template <class Src, bool kRing, class Out>
__device__ __forceinline__ void walk_q(const Src& src, const TailArgs& g,
                                       float* smem, Out* __restrict__ qz) {
  constexpr int kK = kTpRows;
  constexpr int kOut = kK * kTpStrip / kTpThreads;  // outputs a thread
  using Raw = typename Src::Raw;
  const int h = g.h, w = g.w, wp = g.wp, r = g.r;
  const QGeom geo(r, kRing);
  const int k = 2 * r + 1, ti = kTpStrip + 2 * r;
  const int ra = geo.ra, ts = geo.ts, m = geo.m, tb = 4 * kK * ts;
  const int tip = ti + 1, tap = kTpStrip + 1;  // odd row strides
  float* vsum = smem + geo.vsum;
  float* hab = smem + geo.hab;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float coef = static_cast<float>(1.0 / (static_cast<double>(k) * k));
  const int x0 = blockIdx.x * kTpStrip;
  const int y0 = blockIdx.y * g.seg_rows;
  const int y1 = min(y0 + g.seg_rows, h);
  const int e0 = y0 - r;                // extended row of walk row 0
  const int rows_in = y1 - y0 + 2 * r;  // rows the walk takes in
  const int steps = (rows_in + kK - 1) / kK;
  // the a and b planes' rows are 16-byte aligned (wp = round4(w))
  const bool wide = x0 - ra >= 0 && x0 + kTpStrip + ra <= w;

  // walk row u of plane src_plane to dst: a warp's lanes along it
  auto row_in = [&](const float* src_plane, int u, float* dst) {
    const float* row =
        src_plane + static_cast<size_t>(reflect101_fast(e0 + u, h)) * wp;
    if (wide) {
      for (int q = lane; q < ts / 4; q += 32) {
        walker::cp_async16(dst + 4 * q, row + x0 - ra + 4 * q);
      }
    } else {
      for (int c = lane; c < ts; c += 32) {
        walker::cp_async4(dst + c, row + reflect101_fast(x0 - ra + c, w));
      }
    }
  };
  // the rows of step t (ring slots from `base`, or buffer t & 1): a warp a
  // row
  auto stage_in = [&](int t, int base) {
    if constexpr (kRing) {
      for (int j = warp; j < 2 * kK; j += kTpThreads / 32) {
        const int i = j % kK;
        int slot = base + i;
        if (slot >= m) slot -= m;
        row_in(j < kK ? g.a : g.b, t * kK + i,
               smem + ((j < kK ? 0 : m) + slot) * ts);
      }
    } else {
      float* buf = smem + (t & 1) * tb;
      for (int j = warp; j < 4 * kK; j += kTpThreads / 32) {
        const int i = j % kK, leaving = j / (2 * kK);
        const int u = t * kK + i - (leaving ? k : 0);
        if (u < 0) continue;  // before the walk: stage 1 takes 0
        row_in((j / kK) & 1 ? g.b : g.a, u, buf + j * ts);
      }
    }
    walker::cp_async_commit();
  };

  double v[2] = {0.0, 0.0};  // column tid's running sums of a and b
  int base = 0;  // the ring slot of this step's first row
  Raw hold[kOut];
  stage_in(0, 0);
  for (int s = 0; s < steps; ++s) {
    walker::cp_async_wait_all();
    __syncthreads();
    // the next step's rows, over what the step before read, and I at this
    // step's output pixels, read now and used in stage 3
    int next = base + kK;
    if (next >= m) next -= m;
    if (s + 1 < steps) stage_in(s + 1, next);
#pragma unroll
    for (int e = 0; e < kOut; ++e) {
      const int pix = tid + e * kTpThreads;
      const int i = pix / kTpStrip, j = pix % kTpStrip;
      const int u = s * kK + i, y = y0 + u - 2 * r, x = x0 + j;
      if (u >= 2 * r && y < y1 && x < w) hold[e] = src.raw(y, x);
    }

    // 1. running sums down each input column
    if (tid < ti) {
      const float* in = smem + tid + ra - r;
      const float* buf = in + (s & 1) * tb;
#pragma unroll
      for (int i = 0; i < kK; ++i) {
        const float *ex, *ey, *lx, *ly;  // entering and leaving a and b
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
        const bool full = s * kK + i >= k;  // a row leaves the window
        const double dx = *ex, dy = *ey;
        const double dlx = full ? *lx : 0.0f, dly = full ? *ly : 0.0f;
        v[0] += dx - dlx;
        v[1] += dy - dly;
        vsum[i * tip + tid] = static_cast<float>(v[0]);
        vsum[(kK + i) * tip + tid] = static_cast<float>(v[1]);
      }
    }
    __syncthreads();

    // 2. window sums along the rows whose column window is full: a thread an
    //    8-column part of a (plane, row) pair
    {
      constexpr int pairs = 2 * kK, len = kTpStrip / (kTpThreads / pairs);
      const int m2 = tid % pairs, part = tid / pairs;  // m2 = plane*kK + row
      const int u = s * kK + m2 % kK;
      if (u >= 2 * r && u < rows_in) {
        walker::row_window_sums<false>(vsum + m2 * tip, part * len,
                                       (part + 1) * len, r, hab + m2 * tap);
      }
    }
    __syncthreads();

    // 3. q, a warp along a row of the strip
#pragma unroll
    for (int e = 0; e < kOut; ++e) {
      const int pix = tid + e * kTpThreads;
      const int i = pix / kTpStrip, j = pix % kTpStrip;
      const int u = s * kK + i, y = y0 + u - 2 * r, x = x0 + j;
      if (u < 2 * r || y >= y1 || x >= w) continue;
      const float* sums = hab + i * tap + j;
      walker::store_q(qz[static_cast<size_t>(y) * w + x],
                      walker::q_of(sums[0], sums[kK * tap],
                                   src.value(hold[e], y, x), coef));
    }
    base = next;
  }
}

// Walk 1 (kAB: a and b; Out unused) or walk 2 (q as Out: float32, or u8 as
// pipeline.py's _to_u8 rounds it, walker.cuh's store_q) of the tail.
template <class Src, bool kAB, bool kRing, int kRg, class Out>
__global__ void __launch_bounds__(kTpThreads, kAB ? kAbBlocks : kQBlocks)
tail_kernel(const Src src, const TailArgs g, Out* __restrict__ q) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (kAB) {
    walk_ab<Src, kRing, kRg>(src, g, smem);
  } else {
    walk_q<Src, kRing>(src, g, smem, q);
  }
}

// Walk 1's shared-memory bytes with its rings in shared memory, or 0 where
// they pass a block's (the scratch route).
inline size_t ring_bytes(int rg, int r) {
  const long long bytes = AbGeom(rg, r, true).total * 4LL;
  // the taps' static shared memory counts against the same ceiling
  return bytes + 4LL * kMaxTaps <= kMaxSmemBytes ? static_cast<size_t>(bytes)
                                                 : 0;
}

inline bool bad_args(int h, int w, int rg, int r) {
  return rg < 0 || 2 * rg + 1 > kMaxTaps || r < 1 || r > kTailMaxRadius ||
         h <= 2 * r + rg || w <= 2 * r + rg;
}

// Walk 1's grid on the scratch route, which sizes its rings
inline walker::WalkGrid scratch_grid(int h, int w, int r) {
  return walker::strip_grid(1, h, w, kTpStrip, 2 * r, 1, kScratchSlots);
}

// The floats of device scratch a call at these arguments needs (the a and b
// planes, and on walk 1's scratch route its rings), or -1 for arguments the
// tail refuses.
inline long long scratch_floats(int h, int w, int rg, int r) {
  if (bad_args(h, w, rg, r)) return -1;
  const long long planes = 2LL * h * round4(w);
  if (ring_bytes(rg, r) > 0) return planes;
  const walker::WalkGrid g = scratch_grid(h, w, r);
  return planes + static_cast<long long>(g.grid.x) * g.grid.y * 2 *
                      (2LL * r + 1) * (kTpStrip + 2LL * r);
}

// Walk 1's instances, as Launch::route numbers them: its rings in the device
// scratch, or in shared memory at the compile-time gaussian radius or at any
// (walk 2's: 1 with its rows staged in a ring, 0 without)
constexpr int kScratchRoute = 0;
constexpr int kFixedRgRing = 1;
constexpr int kAnyRgRing = 2;

// The configure half of a launch of tail_kernel<Src, kAB, kRing, kRg, Out>
// with `bytes` of shared memory: one wave of the blocks the card holds at
// once, or on walk 1's scratch route the grid its rings were sized for.
template <class Src, bool kAB, bool kRing, int kRg, class Out>
int configure_walk(int h, int w, int r, size_t bytes, int route, Launch* c) {
  auto kernel = tail_kernel<Src, kAB, kRing, kRg, Out>;
  walker::WalkGrid wg;
  if (kAB && !kRing) {
    const cudaError_t err = walker::allow_smem(kernel, bytes);
    smem_ceiling_set();
    if (err != cudaSuccess) return static_cast<int>(err);
    wg = scratch_grid(h, w, r);
  } else {
    long long slots = 0;
    const int err = walker::wave_slots(kernel, kTpThreads, bytes, &slots);
    smem_ceiling_set();
    if (err != 0) return err;
    wg = walker::strip_grid(1, h, w, kTpStrip, 2 * r, 1, slots);
  }
  *c = {reinterpret_cast<const void*>(kernel), wg.grid, wg.seg_rows,
        static_cast<int>(bytes), route};
  return 0;
}

// The launch half: the configured grid, no CUDA query.
template <class Src, bool kAB, bool kRing, int kRg, class Out>
int launch_walk(const Src& src, TailArgs g, const Launch& c, Out* q,
                cudaStream_t stream) {
  g.seg_rows = c.rows;
  tail_kernel<Src, kAB, kRing, kRg, Out>
      <<<c.grid, kTpThreads, c.bytes, stream>>>(src, g, q);
  return static_cast<int>(cudaGetLastError());
}

// Both walks' instances and launches on an (h, w) frame at these radii. At
// the enhance pipeline's default gaussian radius walk 1 runs the instance
// with that radius fixed at compile time.
template <class Src, class Out>
int configure(int h, int w, int rg, int r, TailPlan* p) {
  if (bad_args(h, w, rg, r)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t ab = ring_bytes(rg, r);
  int err;
  if (ab == 0) {
    err = configure_walk<Src, true, false, -1, float>(
        h, w, r, AbGeom(rg, r, false).total * 4, kScratchRoute, &p->walk1);
  } else if (rg == kFixedRg) {
    err = configure_walk<Src, true, true, kFixedRg, float>(
        h, w, r, ab, kFixedRgRing, &p->walk1);
  } else {
    err = configure_walk<Src, true, true, -1, float>(h, w, r, ab, kAnyRgRing,
                                                     &p->walk1);
  }
  if (err != 0) return err;
  if (r <= kTpRingMaxRadius) {
    return configure_walk<Src, false, true, 0, Out>(
        h, w, r, QGeom(r, true).total * 4, 1, &p->walk2);
  }
  return configure_walk<Src, false, false, 0, Out>(
      h, w, r, QGeom(r, false).total * 4, 0, &p->walk2);
}

// The tail on an (h, w) frame as `p` configured it: walk 1 then walk 2 on
// `stream`. taps.w[0 .. 2*rg] are the gaussian weights; scratch:
// scratch_floats(...) floats; out: (h, w) float32 q, or u8 (store_q). Needs
// h, w > 2r + rg (the callers gate on min(h, w) > 2*(2r + rg)).
template <class Src, class Out>
int run(const TailPlan& p, const Src& src, int h, int w, const Taps& taps,
        int rg, int r, float eps, float* scratch, Out* out,
        cudaStream_t stream) {
  if (bad_args(h, w, rg, r) || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int wp = round4(w);
  const size_t plane = static_cast<size_t>(h) * wp;
  const TailArgs g{taps,  scratch, scratch + plane, scratch + 2 * plane,
                   h,     w,       wp,              rg,
                   r,     0,       src.aligned(w),  eps};
  float* none = nullptr;
  int err;
  switch (p.walk1.route) {
    case kScratchRoute:
      err = launch_walk<Src, true, false, -1>(src, g, p.walk1, none, stream);
      break;
    case kFixedRgRing:
      err = launch_walk<Src, true, true, kFixedRg>(src, g, p.walk1, none,
                                                   stream);
      break;
    default:
      err = launch_walk<Src, true, true, -1>(src, g, p.walk1, none, stream);
  }
  if (err != 0) return err;
  return p.walk2.route
             ? launch_walk<Src, false, true, 0>(src, g, p.walk2, out, stream)
             : launch_walk<Src, false, false, 0>(src, g, p.walk2, out,
                                                 stream);
}

// The stand-alone entries' call: configure, then run.
template <class Src, class Out>
int launch(const Src& src, int h, int w, const Taps& taps, int rg, int r,
           float eps, float* scratch, Out* out, cudaStream_t stream) {
  if (bad_args(h, w, rg, r) || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TailPlan p;
  const int err = configure<Src, Out>(h, w, rg, r, &p);
  if (err != 0) return err;
  return run(p, src, h, w, taps, rg, r, eps, scratch, out, stream);
}

}  // namespace tail
