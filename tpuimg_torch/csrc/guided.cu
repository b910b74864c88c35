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
// The walker's body (walker.cuh) is templated on the producer of its rows
// of I and p; here GuidedRows reads them from device memory, and the enhance
// tails (enhance_tail.cuh) produce them on chip from the frame.
//
// Twopass keeps the earlier tile design: one block per 32x32 output tile, the
// tile's (32 + 2r)^2 extent staged through the reflect-101 index, direct
// window sums in the plain version's order; r <= kTwopassMaxRadius = 16.
#include "walker.cuh"

namespace {

using walker::ab_of;
using walker::kRows;
using walker::kStrip;
using walker::kWalkBlocks;
using walker::kWalkThreads;
using walker::q_of;

constexpr int kThreads = 256;

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

  __device__ __forceinline__ void leaving(int u, int, int x, int, int,
                                          float& li, float& lp) const {
    const size_t o =
        static_cast<size_t>(source_row<kYPadded>(e0 + u, h, r)) * w + x;
    li = __ldg(Iz + o);
    if constexpr (!kSelf) lp = __ldg(pz + o);
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

using walker::allow_smem;

bool bad_frames(int n_i, int n, int h, int w) {
  return n_i < 1 || n < 1 || n % n_i != 0 || h < 1 || w < 1;
}

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
