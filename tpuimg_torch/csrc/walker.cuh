// The guided-filter strip walker's body, run by guided.cu's onepass entries
// (frame and row-padded), and the helpers that guided.cu's twopass walks and
// the enhance tails' two walks (enhance_tail.cuh) share with it. The design
// and its bounds are described in guided.cu's header; this file holds the
// body, templated on its row producer, so that each kernel differs only in
// where its rows of I and p come from. kInRange, kCentre, before4, spare
// and late serve a producer that makes its rows on chip; guided.cu's
// GuidedRows reads them and leaves them unset or empty.
//
// A producer (Prod) supplies, for walker row u (extended row e0 + u of the
// block's segment), the values of I and p at strip column c, and does its
// own staging around the walker's barriers:
//   kSelf                    p is I (two of the four sums)
//   kInRange                 its values lie in [0, 1] (say, made from a u8
//                            frame), so the walker leaves out the repair of
//                            its running sums; otherwise it calls
//   row(u, ctx, iu, pu)      I and p at walker row u, any row of the window
//   kCentre                  the producer gives I at the output pixels
//                            (centre(s, i, j): walker row s*kRows + i - 2r,
//                            output column j), so the walker keeps no iring
//   begin(steps)             before the first step (no barrier before it)
//   top(s, steps)            at the top of step s, before its first barrier
//   column(c)                a per-column context for the two calls below
//   leaving(u, i, ctx, c, base, li, lp)   row u = s*kRows + i - (2r + 1)
//   entering(s, i, ctx, c, base, ie, pe)  row s*kRows + i
//   before4(s, steps)        on every thread, before stage 4's barrier
//   spare(s, steps)          on the threads that stage 4 leaves idle
//   late(s, steps)           on every thread, after stage 4, in its phase
//   advance()                at the end of a step
// `base` is the walker's ring slot of this step's first row (mod 2r + 1 +
// kRows), which a producer may use for a ring of its own.
#pragma once

#include <algorithm>
#include <cfloat>

#include "common.cuh"

namespace walker {

constexpr int kStrip = 64;               // output columns of a block
constexpr int kWalkThreads = 128;
// the launch bound: 6 blocks an SM, so 80 registers a thread
constexpr int kWalkBlocks = 6;
constexpr int kRows = kWalkThreads / 32;  // rows a step takes in: a warp each
constexpr int kMinSegRows = 32;
constexpr int kScratchFrames = 8;        // frames in flight, scratch route
constexpr int kStripPad = kStrip + 1;    // row stride of the ring

// A block's workspace, offsets in floats: f64 column sums of the vertical
// pass (np a column), the producer's region (prod floats), a step's vertical
// sums rounded to f32 (np planes of kRows rows of ti + 1), their window sums
// along the rows and then a and b in place (np planes of kRows rows of
// ta + 1), the ring of the second box filter's row sums (2 x kr rows of
// kStrip + 1), and the ring of I at the output columns (ki x kStrip: from the
// row a step takes in until its q is written, 2r rows later). The odd row
// strides put the rows of a column in distinct banks, for the lanes that
// walk along rows side by side.
struct Workspace {
  long long vst, prod, vsum, hab, ring, iring, total;
};

__host__ __device__ inline Workspace workspace_of(int r, bool self_guided,
                                                  long long prod,
                                                  bool iring = true) {
  const long long ti = kStrip + 4LL * r, ta = kStrip + 2LL * r;
  const long long kr = 2LL * r + 1 + kRows, ki = 2LL * r + kRows;
  const long long np = self_guided ? 2 : 4;
  Workspace ws;
  ws.vst = 0;
  ws.prod = 2 * np * ti;
  ws.vsum = ws.prod + prod;
  ws.hab = ws.vsum + np * kRows * (ti + 1);
  ws.ring = ws.hab + np * kRows * (ta + 1);
  ws.iring = ws.ring + 2 * kr * kStripPad;
  ws.total = (ws.iring + (iring ? ki * kStrip : 0) + 3) &
             ~3LL;  // whole 16-byte blocks
  return ws;
}

// The repair of a running window sum (add the entering term, subtract the
// leaving one), which on its own keeps a NaN or an infinity that entered it
// to the end of its walk, and the rounding residue of a large finite term
// after that term has left. After each subtract a sum must be finite, and
// the term that left at most `most` times its magnitude (keeps); where that
// fails, sums are taken again directly from their windows: along the rows
// (f32, most = kRebuildF32 = 64), the sums of a row part from the failing
// one on, each the warm-up of its window (repaired_window_sums); down the
// columns (f64, kRebuildF64 = 2^20, checked on the f32 values the walk
// rounds them to, and on the I*I plane in place of I's, which no signed
// cancellation fools), the column's sums of every row of the step. A
// window's sum then holds a NaN or an infinity only while its window does
// (IEEE's result for a direct sum: NaN for a NaN or both infinities, else
// the infinity), and a large term's residue leaves with it. The residue a
// kept sum carries is at most about `most` ulps of the sum for each add and
// subtract of its window: for the f64 sums, 29 bits more than f32's, less
// than an f32 ulp. A frame without non-finite values or outliers fails no
// check unless a signed sum (of a or b) nearly cancels, so its bits stay
// those of the plain running sums almost everywhere.
constexpr float kRebuildF32 = 64.0f;
constexpr float kRebuildF64 = 1048576.0f;

__device__ __forceinline__ bool keeps(float leaving, float sum, float most) {
  return fabsf(leaving) <= most * fabsf(sum) && fabsf(sum) <= FLT_MAX;
}

// row_window_sums with every sum checked after its subtract and rebuilt (the
// warm-up of the next window) where keeps fails: the repair's careful pass
static __device__ __noinline__ void repaired_window_sums(const float* src,
                                                        int c0, int c1, int r,
                                                        float* out) {
  float sum = 0.0f;
  for (int t = c0; t < c0 + 2 * r; ++t) sum += src[t];
  for (int c = c0; c < c1; ++c) {
    sum += src[c + 2 * r];
    out[c] = sum;
    const float leaving = src[c];
    sum -= leaving;
    if (!keeps(leaving, sum, kRebuildF32) && c + 1 < c1) {
      sum = 0.0f;
      for (int t = c + 1; t <= c + 2 * r; ++t) sum += src[t];
    }
  }
}

// out[c] = src[c] + ... + src[c + 2r] for c in [c0, c1): a running sum along
// the row, 2r warm-up adds and then one add and one subtract a column, in
// the plain version's order within each window's first sum. kRepair: the
// largest term that left and the smallest sum it left are tracked, and
// unless every sum kept (the last one finite, which a NaN or an infinity
// would have made it for good, and the largest term at most kRebuildF32
// times the smallest sum) the part is done again by repaired_window_sums,
// whose outputs equal these up to its first rebuild
template <bool kRepair>
__device__ __forceinline__ void row_window_sums(const float* src, int c0,
                                                int c1, int r, float* out) {
  if (c0 >= c1) return;
  float sum = 0.0f;
  for (int t = c0; t < c0 + 2 * r; ++t) sum += src[t];
  float largest = 0.0f, smallest = FLT_MAX;
#pragma unroll 4
  for (int c = c0; c < c1; ++c) {
    sum += src[c + 2 * r];
    out[c] = sum;
    const float leaving = src[c];
    sum -= leaving;
    if constexpr (kRepair) {
      largest = fmaxf(largest, fabsf(leaving));
      smallest = fminf(smallest, fabsf(sum));
    }
  }
  if constexpr (kRepair) {
    if (!(fabsf(sum) <= FLT_MAX && largest <= kRebuildF32 * smallest)) {
      repaired_window_sums(src, c0, c1, r, out);
    }
  }
}

// cp.async copies and their groups (common.cuh)
using ::cp_async16;
using ::cp_async4;
using ::cp_async_commit;
using ::cp_async_wait_all;
using ::cp_async_wait_one;

// a and b from the four window sums (sums, not means)
__device__ __forceinline__ void ab_of(float si, float sp, float sip, float sii,
                                      float coef, float eps, float* a,
                                      float* b) {
  const float imu = __fmul_rn(si, coef), pmu = __fmul_rn(sp, coef);
  const float ipmu = __fmul_rn(sip, coef), iimu = __fmul_rn(sii, coef);
  const float num = __fsub_rn(ipmu, __fmul_rn(pmu, imu));
  const float den = __fadd_rn(__fsub_rn(iimu, __fmul_rn(imu, imu)), eps);
  *a = __fdiv_rn(num, den);
  *b = __fsub_rn(pmu, __fmul_rn(*a, imu));
}

// q = mean_a * I + mean_b from the window sums of a and b
__device__ __forceinline__ float q_of(float sa, float sb, float i,
                                      float coef) {
  return __fadd_rn(__fmul_rn(__fmul_rn(sa, coef), i), __fmul_rn(sb, coef));
}

// q as the output stores it: a float32 output as it is; a u8 output as
// clamp(rint(q * 255), 0, 255), bit for bit pipeline.py's _to_u8 of the
// float32 q: __fmul_rn keeps the product uncontracted, and __float2uint_rn
// rounds half to even, as torch.round does, and saturates (a negative
// product or NaN gives 0, as the clamp does)
__device__ __forceinline__ void store_q(float& out, float q) { out = q; }
__device__ __forceinline__ void store_q(uint8_t& out, float q) {
  out = static_cast<uint8_t>(min(__float2uint_rn(__fmul_rn(q, 255.0f)), 255u));
}

// v = the np column sums of walker rows u - 2r .. u (rows from 0 on), summed
// directly in row order
template <bool kSelf, class Prod, class Ctx>
__device__ __forceinline__ void column_window(const Prod& prod,
                                              const Ctx& ctx, int u, int r,
                                              double* v) {
  constexpr int np = kSelf ? 2 : 4;
#pragma unroll
  for (int pl = 0; pl < np; ++pl) v[pl] = 0.0;
#pragma unroll 1
  for (int t = max(0, u - 2 * r); t <= u; ++t) {
    float it, pt = 0.0f;
    prod.row(t, ctx, it, pt);
    const double di = it, dp = pt;
    v[0] += di;
    if constexpr (kSelf) {
      v[1] += di * di;
    } else {
      v[1] += dp;
      v[2] += di * dp;
      v[3] += di * di;
    }
  }
}

// The block's workspace: shared memory, or (the scratch route) its slice of
// a device-memory scratch of `total` floats a block.
template <bool kShared>
__device__ __forceinline__ float* block_workspace(float* smem, float* scratch,
                                                  long long total) {
  if constexpr (kShared) return smem;
  const size_t block =
      (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
      blockIdx.x;
  return scratch + block * total;
}

// Walk the block's strip (blockIdx.x) over its segment (blockIdx.y) of one
// (h, w) frame, writing q at its output pixels (store_q: float32, or u8).
// ws and wl: the workspace.
template <class Prod, class Out>
__device__ __forceinline__ void walk_frame(Prod& prod, float* ws,
                                           const Workspace& wl, int h, int w,
                                           int r, float eps, int seg_rows,
                                           Out* __restrict__ qz) {
  constexpr bool kSelf = Prod::kSelf;
  constexpr bool kRepair = !Prod::kInRange;
  constexpr int np = kSelf ? 2 : 4;  // planes summed: I, p, I*p, I*I
  double* vst = reinterpret_cast<double*>(ws + wl.vst);
  float* vsum = ws + wl.vsum;
  float* hab = ws + wl.hab;
  float* ring = ws + wl.ring;
  float* iring = ws + wl.iring;

  const int k = 2 * r + 1;
  const int ti = kStrip + 4 * r, ta = kStrip + 2 * r, kr = k + kRows;
  const int ki = 2 * r + kRows;
  const int tip = ti + 1, tap = ta + 1;  // odd row strides
  const int vplane = kRows * tip;        // a plane of vsum
  const int hplane = kRows * tap;        // a plane of hab
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the same f32 coefficient as the host's float32(1.0 / ksz^2)
  const float coef = static_cast<float>(1.0 / (static_cast<double>(k) * k));
  const int x0 = blockIdx.x * kStrip;
  const int y0 = blockIdx.y * seg_rows;
  const int y1 = min(y0 + seg_rows, h);
  const int rows_in = y1 - y0 + 4 * r;  // input rows the walk takes in
  const int steps = (rows_in + kRows - 1) / kRows;
  // the horizontal passes: a thread runs along one part (of len_v or len_ab
  // columns) of one (row, plane) pair of a step, np planes of the vertical
  // sums (stage 2) and then a and b (stage 3). The self-guided form cuts its
  // rows into the general form's parts, so that it sums in the same order
  // and equals the general form with p = I bit for bit.
  constexpr int pairs_v = kRows * np, pairs_ab = kRows * 2;
  constexpr int parts_v = kWalkThreads / (kRows * 4);
  constexpr int parts_ab = kWalkThreads / pairs_ab;
  const int len_v = ((ta + parts_v - 1) / parts_v) | 1;
  const int len_ab = ((kStrip + parts_ab - 1) / parts_ab) | 1;

  for (int i = tid; i < np * ti; i += kWalkThreads) vst[i] = 0.0;
  for (int i = tid; i < 2 * kr * kStripPad; i += kWalkThreads) ring[i] = 0.0f;
  double sa = 0.0, sb = 0.0;  // output column tid's sums of a and b
  int base = 0;   // ring slot of this step's first row
  int ibase = 0;  // iring slot of this step's first row
  prod.begin(steps);

  for (int s = 0; s < steps; ++s) {
    prod.top(s, steps);
    __syncthreads();

    // 1. vertical running sums, a thread per input column: after row u the
    //    column's sums cover input rows u - 2r .. u (centre row u - r)
    for (int c = tid; c < ti; c += kWalkThreads) {
      const auto ctx = prod.column(c);
      const int j = c - 2 * r;  // output column j keeps its I in iring
      const bool keep = !Prod::kCentre && j >= 0 && j < kStrip;
      // the rows leaving the window this step (2r + 1 rows above the
      // entering ones; zero before the window is full), all loaded before
      // the running sums wait on the first
      float li[kRows], lp[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int u = s * kRows + i - k;
        li[i] = 0.0f;
        lp[i] = 0.0f;
        if (u >= 0) prod.leaving(u, i, ctx, c, base, li[i], lp[i]);
      }
      double v[np];
#pragma unroll
      for (int pl = 0; pl < np; ++pl) v[pl] = vst[pl * ti + c];
      bool kept = true;  // every row's sums kept (the repair, keeps)
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float ie, pe;
        prod.entering(s, i, ctx, c, base, ie, pe);
        if (keep) {
          int slot = ibase + i;
          if (slot >= ki) slot -= ki;
          iring[slot * kStrip + j] = ie;
        }
        // entering minus leaving; f32 values and their products are exact
        // in f64
        const double di = ie, dl = li[i];
        v[0] += di - dl;
        if constexpr (kSelf) {
          v[1] += di * di - dl * dl;
        } else {
          const double dp = pe, dq = lp[i];
          v[1] += dp - dq;
          v[2] += di * dp - dl * dq;
          v[3] += di * di - dl * dl;
        }
        float f[np];
#pragma unroll
        for (int pl = 0; pl < np; ++pl) {
          f[pl] = static_cast<float>(v[pl]);
          vsum[pl * vplane + i * tip + c] = f[pl];
        }
        if constexpr (kRepair) {  // checked on the planes of p and of I*I
          kept &= keeps(li[i] * li[i], f[np - 1], kRebuildF64) &
                  (kSelf || keeps(lp[i], f[1], kRebuildF64));
        }
      }
      if constexpr (kRepair) {
        // a step with a sum that failed: every row's sums of this column
        // summed again directly
        if (!kept) {
#pragma unroll 1
          for (int i = 0; i < kRows; ++i) {
            column_window<kSelf>(prod, ctx, s * kRows + i, r, v);
#pragma unroll
            for (int pl = 0; pl < np; ++pl) {
              vsum[pl * vplane + i * tip + c] = static_cast<float>(v[pl]);
            }
          }
        }
      }
#pragma unroll
      for (int pl = 0; pl < np; ++pl) vst[pl * ti + c] = v[pl];
    }
    __syncthreads();

    // 2. window sums along the rows of each plane (a thread a part of a
    //    (row, plane) pair), then a and b in place (a warp a row); zero on
    //    rows whose vertical window is not full, so that they add nothing
    //    below
    {
      const int m = tid % pairs_v, i = m % kRows, u = s * kRows + i;
      const int c0 = tid / pairs_v * len_v, c1 = min(c0 + len_v, ta);
      const int o = m / kRows * vplane + i * tip;  // plane m / kRows, row i
      if (u >= 2 * r && u < rows_in) {
        row_window_sums<kRepair>(vsum + o, c0, c1, r,
                                 hab + m / kRows * hplane + i * tap);
      }
    }
    __syncthreads();
    {
      const int u = s * kRows + warp;
      const bool full = u >= 2 * r && u < rows_in;
      float* h0 = hab + warp * tap;  // plane 0 of row warp
      for (int c = lane; c < ta; c += 32) {
        float a = 0.0f, b = 0.0f;
        if (full) {
          if constexpr (kSelf) {
            ab_of(h0[c], h0[c], h0[hplane + c], h0[hplane + c], coef, eps, &a,
                  &b);
          } else {
            ab_of(h0[c], h0[hplane + c], h0[2 * hplane + c],
                  h0[3 * hplane + c], coef, eps, &a, &b);
          }
        }
        h0[c] = a;
        h0[hplane + c] = b;
      }
    }
    __syncthreads();

    // 3. window sums of a and b along each row into the ring (a thread a
    //    part of a (row, a or b) pair)
    {
      const int m = tid % pairs_ab, i = m % kRows, pl = m / kRows;
      const int c0 = tid / pairs_ab * len_ab, c1 = min(c0 + len_ab, kStrip);
      int slot = base + i;
      if (slot >= kr) slot -= kr;
      row_window_sums<kRepair>(hab + pl * hplane + i * tap, c0, c1, r,
                               ring + (pl * kr + slot) * kStripPad);
    }
    prod.before4(s, steps);
    __syncthreads();

    // 4. running sums of the ring down each output column, then q. Ring
    //    slot of row v: v mod kr; the row leaving (v - k) sits kRows slots
    //    ahead. Output row yo = u - 4r + y0 once its window is full; its I
    //    is walker row u - 2r's, in iring slot (u - 2r) mod ki. The other
    //    threads do the producer's spare work.
    if (tid < kStrip) {
      const int x = x0 + tid;
      // q of row i of the step from the f32 window sums of a and b
      auto emit = [&](int i, float fa, float fb) {
        const int yo = y0 + s * kRows + i - 4 * r;
        if (yo >= y0 && yo < y1 && x < w) {
          float ic;
          if constexpr (Prod::kCentre) {
            ic = prod.centre(s, i, tid);
          } else {
            int is = ibase + i - 2 * r;
            if (is < 0) {
              is += ki;
            } else if (is >= ki) {
              is -= ki;
            }
            ic = iring[is * kStrip + tid];
          }
          store_q(qz[static_cast<size_t>(yo) * w + x],
                  q_of(fa, fb, ic, coef));
        }
      };
      bool kept = true;  // every row's sums kept (the repair, keeps)
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        int slot = base + i;
        if (slot >= kr) slot -= kr;
        int old = slot + kRows;
        if (old >= kr) old -= kr;
        const float la = ring[old * kStripPad + tid];
        const float lb = ring[(kr + old) * kStripPad + tid];
        sa += static_cast<double>(ring[slot * kStripPad + tid]) -
              static_cast<double>(la);
        sb += static_cast<double>(ring[(kr + slot) * kStripPad + tid]) -
              static_cast<double>(lb);
        const float fa = static_cast<float>(sa), fb = static_cast<float>(sb);
        if constexpr (kRepair) {
          kept &= keeps(la, fa, kRebuildF64) & keeps(lb, fb, kRebuildF64);
        }
        emit(i, fa, fb);
      }
      if constexpr (kRepair) {
        // a step with a sum that failed: every row's sums of this column
        // summed again directly from the window's 2r + 1 ring rows, oldest
        // first (the ring holds zeros for rows before the walk), and its q
        // written again
        if (!kept) {
#pragma unroll 1
          for (int i = 0; i < kRows; ++i) {
            int t = (base + i - 2 * r) % kr;
            if (t < 0) t += kr;
            sa = 0.0;
            sb = 0.0;
            for (int j = 0; j <= 2 * r; ++j) {
              sa += static_cast<double>(ring[t * kStripPad + tid]);
              sb += static_cast<double>(ring[(kr + t) * kStripPad + tid]);
              if (++t == kr) t = 0;
            }
            emit(i, static_cast<float>(sa), static_cast<float>(sb));
          }
        }
      }
    } else {
      prod.spare(s, steps);
    }
    prod.late(s, steps);
    base += kRows;
    if (base >= kr) base -= kr;
    ibase += kRows;
    if (ibase >= ki) ibase -= ki;
    prod.advance();
  }
}

// ---- launches --------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();  // clear it; returned below
  return err;
}

// A walk's grid: strips of `strip` columns, segments of seg_rows output
// rows, and frames (at most `frames` blocks deep). Segments are as many as
// fit in one wave of `slots` resident blocks (a second, partial wave would
// double the time), none shorter than max(kMinSegRows, halo): each pays
// `halo` rows of input beyond its own.
struct WalkGrid {
  dim3 grid;
  int seg_rows;
};

inline WalkGrid strip_grid(int n, int h, int w, int strip, int halo,
                           int frames_max, long long slots) {
  const long long strips = (w + strip - 1) / strip;
  const long long frames = std::min(n, frames_max);
  const long long min_rows = std::max(kMinSegRows, halo);
  const long long segs = std::max(
      1LL, std::min(slots / (strips * frames), (h + min_rows - 1) / min_rows));
  const int rows = static_cast<int>((h + segs - 1) / segs);
  return {dim3(static_cast<unsigned>(strips),
               static_cast<unsigned>((h + rows - 1) / rows),
               static_cast<unsigned>(frames)),
          rows};
}

// The onepass walker's grid: kStrip columns, a halo of 4r rows.
inline WalkGrid walk_grid(int n, int h, int w, int r, bool shared,
                          long long slots) {
  return strip_grid(n, h, w, kStrip, 4 * r, shared ? 65535 : kScratchFrames,
                    slots);
}

// The scratch route sizes its scratch from the grid, so its wave is fixed:
// kWalkBlocks on each of an H100's 132 SMs.
constexpr long long kScratchSlots = kWalkBlocks * 132LL;

// Raise `kernel`'s shared memory to `bytes` and count the blocks of
// `threads` this card holds at once at that footprint. Returns the CUDA
// error code; the count in *slots.
template <typename Kernel>
int wave_slots(Kernel kernel, int threads, size_t bytes, long long* slots) {
  cudaError_t err = allow_smem(kernel, bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *slots = std::max(1LL, static_cast<long long>(sms) * per_sm);
  return 0;
}

// Find the onepass walker's grid: one wave of the blocks this card holds at
// once at `bytes` of shared memory (the shared-memory route), or (bytes ==
// 0, the scratch route) kScratchSlots. Returns the CUDA error code; the grid
// in *g.
template <typename Kernel>
int plan_walk(Kernel kernel, size_t bytes, int n, int h, int w, int r,
              WalkGrid* g) {
  long long slots = kScratchSlots;
  if (bytes > 0) {
    const int err = wave_slots(kernel, kWalkThreads, bytes, &slots);
    if (err != 0) return err;
  }
  *g = walk_grid(n, h, w, r, bytes > 0, slots);
  return 0;
}

}  // namespace walker
