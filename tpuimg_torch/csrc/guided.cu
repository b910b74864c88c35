// Guided filter on batches of float32 frames, reflect-101 border, 1/ksz^2
// normalisation (the reference's fused hGuidedFilter path), in two forms:
//
//   onepass: one launch. q never needs a and b in device memory.
//   twopass: the reference's gCalcAB / gWeightByABm split. Launch 1 writes
//            the per-pixel a and b to device memory, launch 2 box-sums them
//            through the reflect-101 index and writes q.
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
//   version's reflected a and b). A NaN or infinity in I or p stays in the
//   running sums of its column strip to the end of the segment, where direct
//   sums keep it to its windows.
//
// Twopass keeps the earlier tile design: one block per 32x32 output tile, the
// tile's (32 + 2r)^2 extent staged through the reflect-101 index, direct
// window sums in the plain version's order; r <= kTwopassMaxRadius = 16.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// ---- onepass: the strip walker ---------------------------------------------

constexpr int kStrip = 64;               // output columns of a block
constexpr int kWalkThreads = 128;
// the launch bound: 6 blocks an SM, so 80 registers a thread
constexpr int kWalkBlocks = 6;
constexpr int kRows = kWalkThreads / 32;  // rows a step takes in: a warp each
constexpr int kSmemMaxRadius = 64;       // the shared-memory route's ceiling
constexpr int kScratchMaxRadius = 1 << 22;  // keeps every index in an int
constexpr int kMinSegRows = 32;
constexpr int kScratchFrames = 8;        // frames in flight, scratch route

constexpr int kStripPad = kStrip + 1;    // row stride of the ring

// A block's workspace, offsets in floats: f64 column sums of the vertical
// pass (np a column), the two buffers of staged input rows (shared-memory
// route only), a step's vertical sums rounded to f32 (np planes of kRows
// rows of ti + 1), their window sums along the rows and then a and b in
// place (np planes of kRows rows of ta + 1), the ring of the second box
// filter's row sums (2 x kr rows of kStrip + 1), and the ring of I at the
// output columns (ki x kStrip: from the row a step takes in until its q is
// written, 2r rows later). The odd row strides put the rows of a column in
// distinct banks, for the lanes that walk along rows side by side.
struct Workspace {
  long long vst, stg, vsum, hab, ring, iring, total;
};

__host__ __device__ inline Workspace workspace_of(int r, bool self_guided,
                                                  bool staged) {
  const long long ti = kStrip + 4LL * r, ta = kStrip + 2LL * r;
  const long long kr = 2LL * r + 1 + kRows, ki = 2LL * r + kRows;
  const long long np = self_guided ? 2 : 4, ns = self_guided ? 1 : 2;
  Workspace ws;
  ws.vst = 0;
  ws.stg = 2 * np * ti;
  ws.vsum = ws.stg + (staged ? 2 * ns * kRows * ti : 0);
  ws.hab = ws.vsum + np * kRows * (ti + 1);
  ws.ring = ws.hab + np * kRows * (ta + 1);
  ws.iring = ws.ring + 2 * kr * kStripPad;
  ws.total = (ws.iring + ki * kStrip + 3) & ~3LL;  // whole 16-byte blocks
  return ws;
}

// out[c] = src[c] + ... + src[c + 2r] for c in [c0, c1): a running sum along
// the row, 2r warm-up adds and then one add and one subtract a column, in
// the plain version's order within each window's first sum
__device__ __forceinline__ void row_window_sums(const float* src, int c0,
                                                int c1, int r, float* out) {
  if (c0 >= c1) return;
  float sum = 0.0f;
  for (int t = c0; t < c0 + 2 * r; ++t) sum += src[t];
#pragma unroll 4
  for (int c = c0; c < c1; ++c) {
    sum += src[c + 2 * r];
    out[c] = sum;
    sum -= src[c];
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the source row of extended row e: reflect-101 in a frame; in a row-padded
// block e + 2r (its own halo rows), clamped at its last row for the rows a
// final step reads past the segment
template <bool kYPadded>
__device__ __forceinline__ int source_row(int e, int h, int r) {
  return kYPadded ? min(e + 2 * r, h + 4 * r - 1) : reflect101_fast(e, h);
}

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

// Step t's kRows input rows of I (and p) over the strip's ti columns into
// buffer t & 1 with cp.async: a warp a row, lanes along it.
template <bool kSelf, bool kYPadded>
__device__ __forceinline__ void stage_step(int t, const float* Iz,
                                           const float* pz, int e0, int x0,
                                           int h, int w, int r, int ti,
                                           float* stg) {
  constexpr int ns = kSelf ? 1 : 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row =
      static_cast<size_t>(source_row<kYPadded>(e0 + t * kRows + warp, h, r)) *
      w;
  float* dst = stg + static_cast<size_t>((t & 1) * ns * kRows + warp) * ti;
  for (int c = lane; c < ti; c += 32) {
    const int x = reflect101_fast(x0 - 2 * r + c, w);
    cp_async4(dst + c, Iz + row + x);
    if constexpr (!kSelf) cp_async4(dst + kRows * ti + c, pz + row + x);
  }
}

// kYPadded: I and p frames are (h + 4r, w) blocks whose rows are padded.
// kShared: the workspace in shared memory and input rows staged there, or
// (the scratch route) in device memory at scratch, workspace_of(...).total
// floats a block.
template <bool kSelf, bool kYPadded, bool kShared>
__global__ void __launch_bounds__(kWalkThreads, kWalkBlocks)
guided_walk_kernel(const float* __restrict__ I, int n_i,
                   const float* __restrict__ p, int n, int h, int w, int r,
                   float eps, int seg_rows, float* __restrict__ scratch,
                   float* __restrict__ q) {
  extern __shared__ __align__(16) float smem[];
  constexpr int np = kSelf ? 2 : 4;  // planes summed: I, p, I*p, I*I
  constexpr int ns = kSelf ? 1 : 2;  // planes staged: I, p
  const Workspace wl = workspace_of(r, kSelf, kShared);
  float* ws;
  if constexpr (kShared) {
    ws = smem;
  } else {
    const size_t block =
        (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
            gridDim.x + blockIdx.x;
    ws = scratch + block * wl.total;
  }
  double* vst = reinterpret_cast<double*>(ws + wl.vst);
  float* stg = ws + wl.stg;
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
  const int hin = kYPadded ? h + 4 * r : h;  // rows of a source frame
  const size_t in_plane = static_cast<size_t>(hin) * w;
  const size_t out_plane = static_cast<size_t>(h) * w;
  const int x0 = blockIdx.x * kStrip;
  const int y0 = blockIdx.y * seg_rows;
  const int y1 = min(y0 + seg_rows, h);
  const int rows_in = y1 - y0 + 4 * r;  // input rows the walk takes in
  const int steps = (rows_in + kRows - 1) / kRows;
  const int e0 = y0 - 2 * r;  // extended row of the walk's first input row
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

  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    const float* Iz = I + static_cast<size_t>(z % n_i) * in_plane;
    const float* pz = kSelf ? Iz : p + static_cast<size_t>(z) * in_plane;
    float* qz = q + static_cast<size_t>(z) * out_plane;
    for (int i = tid; i < np * ti; i += kWalkThreads) vst[i] = 0.0;
    for (int i = tid; i < 2 * kr * kStripPad; i += kWalkThreads) {
      ring[i] = 0.0f;
    }
    double sa = 0.0, sb = 0.0;  // output column tid's sums of a and b
    int base = 0;   // ring slot of this step's first row
    int ibase = 0;  // iring slot of this step's first row
    if constexpr (kShared) {
      stage_step<kSelf, kYPadded>(0, Iz, pz, e0, x0, h, w, r, ti, stg);
      cp_async_commit();
    }

    for (int s = 0; s < steps; ++s) {
      if constexpr (kShared) {
        if (s + 1 < steps) {
          stage_step<kSelf, kYPadded>(s + 1, Iz, pz, e0, x0, h, w, r, ti,
                                      stg);
        }
        cp_async_commit();
        cp_async_wait_one();
      }
      __syncthreads();

      // 1. vertical running sums, a thread per input column: after row u the
      //    column's sums cover input rows u - 2r .. u (centre row u - r)
      {
        const int splane = kRows * ti;  // a plane of a staging buffer
        const float* sI = stg + static_cast<size_t>((s & 1) * ns) * splane;
        for (int c = tid; c < ti; c += kWalkThreads) {
          const int x = reflect101_fast(x0 - 2 * r + c, w);
          const int j = c - 2 * r;  // output column j keeps its I in iring
          const bool keep = j >= 0 && j < kStrip;
          // the rows leaving the window this step (2r + 1 rows above the
          // entering ones; zero before the window is full), all loaded
          // before the running sums wait on the first
          float li[kRows], lp[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int u = s * kRows + i - k;
            li[i] = 0.0f;
            lp[i] = 0.0f;
            if (u >= 0) {
              const size_t o =
                  static_cast<size_t>(source_row<kYPadded>(e0 + u, h, r)) * w +
                  x;
              li[i] = __ldg(Iz + o);
              if constexpr (!kSelf) lp[i] = __ldg(pz + o);
            }
          }
          double v[np];
#pragma unroll
          for (int pl = 0; pl < np; ++pl) v[pl] = vst[pl * ti + c];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            float ie, pe;
            if constexpr (kShared) {
              ie = sI[i * ti + c];
              pe = kSelf ? ie : sI[splane + i * ti + c];
            } else {
              const size_t o = static_cast<size_t>(source_row<kYPadded>(
                                   e0 + s * kRows + i, h, r)) * w + x;
              ie = __ldg(Iz + o);
              pe = kSelf ? ie : __ldg(pz + o);
            }
            if (keep) {
              int slot = ibase + i;
              if (slot >= ki) slot -= ki;
              iring[slot * kStrip + j] = ie;
            }
            // entering minus leaving; f32 values and their products are
            // exact in f64
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
#pragma unroll
            for (int pl = 0; pl < np; ++pl) {
              vsum[pl * vplane + i * tip + c] = static_cast<float>(v[pl]);
            }
          }
#pragma unroll
          for (int pl = 0; pl < np; ++pl) vst[pl * ti + c] = v[pl];
        }
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
          row_window_sums(vsum + o, c0, c1, r,
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
              ab_of(h0[c], h0[c], h0[hplane + c], h0[hplane + c], coef, eps,
                    &a, &b);
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
        row_window_sums(hab + pl * hplane + i * tap, c0, c1, r,
                        ring + (pl * kr + slot) * kStripPad);
      }
      __syncthreads();

      // 4. running sums of the ring down each output column, then q. Ring
      //    slot of row v: v mod kr; the row leaving (v - k) sits kRows slots
      //    ahead. Output row yo = u - 4r + y0 once its window is full; its I
      //    is walker row u - 2r's, in iring slot (u - 2r) mod ki.
      if (tid < kStrip) {
        const int x = x0 + tid;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          int slot = base + i;
          if (slot >= kr) slot -= kr;
          int old = slot + kRows;
          if (old >= kr) old -= kr;
          sa += static_cast<double>(ring[slot * kStripPad + tid]) -
                static_cast<double>(ring[old * kStripPad + tid]);
          sb += static_cast<double>(ring[(kr + slot) * kStripPad + tid]) -
                static_cast<double>(ring[(kr + old) * kStripPad + tid]);
          const int yo = y0 + s * kRows + i - 4 * r;
          if (yo >= y0 && yo < y1 && x < w) {
            int is = ibase + i - 2 * r;
            if (is < 0) {
              is += ki;
            } else if (is >= ki) {
              is -= ki;
            }
            qz[static_cast<size_t>(yo) * w + x] =
                q_of(static_cast<float>(sa), static_cast<float>(sb),
                     iring[is * kStrip + tid], coef);
          }
        }
      }
      base += kRows;
      if (base >= kr) base -= kr;
      ibase += kRows;
      if (ibase >= ki) ibase -= ki;
    }
    __syncthreads();  // the next frame zeroes what step 4 read
  }
}

// ---- twopass: the tile kernels --------------------------------------------

constexpr int kTile = 32;
constexpr int kTwopassMaxRadius = 16;

// launch 1 keeps 4 planes of row sums, launch 2 two
__host__ __device__ int twopass_smem_words(int r, int planes) {
  const int ext = kTile + 2 * r;
  return 2 * ext * ext + planes * ext * kTile + 2 * ext;
}

// twopass launch 1 (gCalcAB): a and b of every pixel into device memory
__global__ void __launch_bounds__(kThreads)
guided_ab_kernel(const float* __restrict__ I, int n_i,
                 const float* __restrict__ p, int n, int h, int w, int r,
                 float eps, float* __restrict__ a_out,
                 float* __restrict__ b_out) {
  extern __shared__ float smem[];
  const int ksz = 2 * r + 1;
  const int ext = kTile + 2 * r;
  float* EI = smem;             // ext x ext
  float* EP = EI + ext * ext;   // ext x ext
  float* X = EP + ext * ext;    // 4 planes of ext x kTile
  int* YS = reinterpret_cast<int*>(X + 4 * ext * kTile);
  int* XS = YS + ext;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const float coef = static_cast<float>(1.0 / (ksz * ksz));
  const size_t plane = static_cast<size_t>(h) * w;
  const int xplane = ext * kTile;
  reflect101_table(y0 - r, ext, h, YS);
  reflect101_table(x0 - r, ext, w, XS);
  __syncthreads();

  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    stage_rows(I + (z % n_i) * plane, w, YS, ext, XS, ext, EI);
    stage_rows(p + z * plane, w, YS, ext, XS, ext, EP);
    __syncthreads();

    for (int i = tid; i < xplane; i += kThreads) {
      const int row = i / kTile, col = i - row * kTile;
      const float* ip = EI + row * ext + col;
      const float* pp = EP + row * ext + col;
      float si = ip[0], sp = pp[0];
      float sip = __fmul_rn(ip[0], pp[0]), sii = __fmul_rn(ip[0], ip[0]);
      for (int k = 1; k < ksz; ++k) {
        si = __fadd_rn(si, ip[k]);
        sp = __fadd_rn(sp, pp[k]);
        sip = __fadd_rn(sip, __fmul_rn(ip[k], pp[k]));
        sii = __fadd_rn(sii, __fmul_rn(ip[k], ip[k]));
      }
      X[i] = si;
      X[xplane + i] = sp;
      X[2 * xplane + i] = sip;
      X[3 * xplane + i] = sii;
    }
    __syncthreads();

    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int row = i / kTile, col = i - row * kTile;
      const int y = y0 + row, x = x0 + col;
      if (y >= h || x >= w) continue;
      float si = X[i], sp = X[xplane + i];
      float sip = X[2 * xplane + i], sii = X[3 * xplane + i];
      for (int k = 1; k < ksz; ++k) {
        const int j = i + k * kTile;
        si = __fadd_rn(si, X[j]);
        sp = __fadd_rn(sp, X[xplane + j]);
        sip = __fadd_rn(sip, X[2 * xplane + j]);
        sii = __fadd_rn(sii, X[3 * xplane + j]);
      }
      float a, b;
      ab_of(si, sp, sip, sii, coef, eps, &a, &b);
      const size_t o = z * plane + static_cast<size_t>(y) * w + x;
      a_out[o] = a;
      b_out[o] = b;
    }
    __syncthreads();
  }
}

// twopass launch 2 (gWeightByABm): q from the box sums of a and b
__global__ void __launch_bounds__(kThreads)
guided_q_kernel(const float* __restrict__ I, int n_i,
                const float* __restrict__ a_in, const float* __restrict__ b_in,
                int n, int h, int w, int r, float* __restrict__ q) {
  extern __shared__ float smem[];
  const int ksz = 2 * r + 1;
  const int ext = kTile + 2 * r;
  float* EA = smem;             // ext x ext
  float* EB = EA + ext * ext;   // ext x ext
  float* X = EB + ext * ext;    // 2 planes of ext x kTile
  int* YS = reinterpret_cast<int*>(X + 2 * ext * kTile);
  int* XS = YS + ext;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const float coef = static_cast<float>(1.0 / (ksz * ksz));
  const size_t plane = static_cast<size_t>(h) * w;
  const int xplane = ext * kTile;
  reflect101_table(y0 - r, ext, h, YS);
  reflect101_table(x0 - r, ext, w, XS);
  __syncthreads();

  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    stage_rows(a_in + z * plane, w, YS, ext, XS, ext, EA);
    stage_rows(b_in + z * plane, w, YS, ext, XS, ext, EB);
    __syncthreads();

    for (int i = tid; i < xplane; i += kThreads) {
      const int row = i / kTile, col = i - row * kTile;
      const float* ap = EA + row * ext + col;
      const float* bp = EB + row * ext + col;
      float sa = ap[0], sb = bp[0];
      for (int k = 1; k < ksz; ++k) {
        sa = __fadd_rn(sa, ap[k]);
        sb = __fadd_rn(sb, bp[k]);
      }
      X[i] = sa;
      X[xplane + i] = sb;
    }
    __syncthreads();

    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int row = i / kTile, col = i - row * kTile;
      const int y = y0 + row, x = x0 + col;
      if (y >= h || x >= w) continue;
      float sa = X[i], sb = X[xplane + i];
      for (int k = 1; k < ksz; ++k) {
        sa = __fadd_rn(sa, X[i + k * kTile]);
        sb = __fadd_rn(sb, X[xplane + i + k * kTile]);
      }
      const size_t pix = static_cast<size_t>(y) * w + x;
      q[z * plane + pix] = q_of(sa, sb, I[(z % n_i) * plane + pix], coef);
    }
    __syncthreads();
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

bool bad_frames(int n_i, int n, int h, int w) {
  return n_i < 1 || n < 1 || n % n_i != 0 || h < 1 || w < 1;
}

// The walker's grid: strips of kStrip columns, segments of seg_rows output
// rows, and frames. Segments are as many as fit in one wave of `slots`
// resident blocks (a second, partial wave would double the time), none
// shorter than max(kMinSegRows, 4r), whose halo each pays.
struct WalkGrid {
  dim3 grid;
  int seg_rows;
};

WalkGrid walk_grid(int n, int h, int w, int r, bool shared, long long slots) {
  const long long strips = (w + kStrip - 1) / kStrip;
  const long long frames = std::min(n, shared ? 65535 : kScratchFrames);
  const long long min_rows = std::max(kMinSegRows, 4 * r);
  const long long segs = std::max(
      1LL, std::min(slots / (strips * frames), (h + min_rows - 1) / min_rows));
  const int rows = static_cast<int>((h + segs - 1) / segs);
  return {dim3(static_cast<unsigned>(strips),
               static_cast<unsigned>((h + rows - 1) / rows),
               static_cast<unsigned>(frames)),
          rows};
}

// The scratch route sizes its scratch from the grid, so its wave is fixed:
// kWalkBlocks on each of an H100's 132 SMs.
constexpr long long kScratchSlots = kWalkBlocks * 132LL;

template <bool kSelf, bool kYPadded, bool kShared>
int launch_walk(const float* I, int n_i, const float* p, int n, int h, int w,
                int r, float eps, float* scratch, float* q,
                cudaStream_t stream) {
  auto kernel = guided_walk_kernel<kSelf, kYPadded, kShared>;
  size_t bytes = 0;
  long long slots = kScratchSlots;
  if (kShared) {
    bytes = static_cast<size_t>(workspace_of(r, kSelf, true).total) *
            sizeof(float);
    cudaError_t err = allow_smem(kernel, bytes);
    // the blocks this card holds at once at this shared-memory footprint
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kWalkThreads, bytes);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    slots = std::max(1LL, static_cast<long long>(sms) * per_sm);
  }
  const WalkGrid g = walk_grid(n, h, w, r, kShared, slots);
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
  const WalkGrid g = walk_grid(n, h, w, r, false, kScratchSlots);
  return workspace_of(r, self_guided != 0, false).total * g.grid.x *
         g.grid.y * g.grid.z;
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

// As tpuimg_guided_onepass, general only, r <= 16; a, b: n frames of
// scratch.
extern "C" int tpuimg_guided_twopass(const float* I, int n_i, const float* p,
                                     int n, int h, int w, int r, float eps,
                                     float* a, float* b, float* q,
                                     cudaStream_t stream) {
  if (bad_frames(n_i, n, h, w) || r < 1 || r > kTwopassMaxRadius) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes_ab = static_cast<size_t>(twopass_smem_words(r, 4)) * 4;
  const size_t bytes_q = static_cast<size_t>(twopass_smem_words(r, 2)) * 4;
  cudaError_t err = allow_smem(guided_ab_kernel, bytes_ab);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(guided_q_kernel, bytes_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile,
                  n < 65535 ? n : 65535);
  guided_ab_kernel<<<grid, kThreads, bytes_ab, stream>>>(I, n_i, p, n, h, w,
                                                         r, eps, a, b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  guided_q_kernel<<<grid, kThreads, bytes_q, stream>>>(I, n_i, a, b, n, h, w,
                                                       r, q);
  return static_cast<int>(cudaGetLastError());
}
