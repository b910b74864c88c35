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
// and :169). The TPU's row bands, column strips of at most 2048 lanes and
// (8, 128) padding have no counterpart here.
//
// The algebra is the plain version's (tpuimg_torch/kernels/boxsum.py::
// guided_chain): the box mean of x is (row window sums, then column window
// sums) * coef with coef = f32(1 / ksz^2); a = (mean_Ip - mean_p*mean_I) /
// (mean_II - mean_I^2 + eps); b = mean_p - a*mean_I; q = mean_a*I + mean_b.
// Window sums add left to right, products are taken before the sum, and
// every multiply and add is rounded on its own (__fmul_rn/__fadd_rn), so
// away from the border the kernels equal the plain version bit for bit.
// Self-guided (p is I) keeps two of the four sums (mean_p = mean_I,
// mean_Ip = mean_II), a template flag of the onepass kernel whose result is
// the general kernel's with p = I, bit for bit.
//
// Design on this card: one block per 32x32 output tile of one frame;
// gridDim.z runs over the frames of p (the I frame is z mod n_i, so C
// channels of p share one guide, the reference's CN1 form). Onepass stages
// the tile's (32 + 4r)^2 extent of I (and p) through the iterated
// reflect-101 index (two index tables of the extent's reflected rows and
// columns, computed once per block), then, all in shared memory:
//   E (extent) -> X (row window sums of I, p, I*p, I*I over (32+4r) x (32+2r))
//   -> A, B (a and b over the (32+2r)^2 ring) -> X (row sums of a, b)
//   -> q in device memory.
// a and b on the ring come from the extent's own windows: the reflected
// frame is symmetric about each edge, so they equal the plain version's
// reflected a and b up to the order of the sums.
// Bound: shared-memory loads, about 4(2r + 1)(1 + 4r/32)(1 + 2r/32) +
// 2(2r + 1)(1 + 2r/32) + 2(2r + 1) per output pixel for the general filter,
// against 12 bytes of device memory. Shared memory: general onepass at
// r = 16 takes 205,568 bytes of the 227 KB a block may use; the wrapper
// sends no radius above 16 (tpuimg's _PALLAS_MAX_RADIUS).
//
// A third entry, tpuimg_guided_onepass_ypadded, replaces
// tpuimg/kernels/boxsum.py::guided_pallas_ypadded (:602; pallas_calls :592
// self-guided and :596 general in _guided_onepass_ypadded :525): a shard's
// block of I (and p) whose rows already carry 2r halo rows on each side,
// (h + 4r, w) in and (h, w) out. The onepass kernel runs as it is, with the
// extent's rows an identity table over the block (common.cuh::
// clamped_table) instead of the reflected one: a and b on the ring rows come
// from the block's real halo rows, as tpuimg's kernel computes them, and x
// is still reflect-101 at 2r in the kernel. The result equals the plain
// version (kernels/boxsum.py::guided_ypadded_plain) bit for bit, since both
// compute a and b on the same padded columns. tpuimg has no radius ceiling
// there; this entry keeps the onepass kernel's r <= 16.
#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kMaxRadius = 16;

// shared memory in 4-byte words: the floats, then two index tables of ext
__host__ __device__ int onepass_smem_words(int r, bool self_guided) {
  const int ext = kTile + 4 * r, rab = kTile + 2 * r;
  const int planes = self_guided ? 2 : 4;
  return (self_guided ? 1 : 2) * ext * ext + planes * ext * rab +
         2 * rab * rab + 2 * ext;
}

// launch 1 keeps 4 planes of row sums, launch 2 two
__host__ __device__ int twopass_smem_words(int r, int planes) {
  const int ext = kTile + 2 * r;
  return 2 * ext * ext + planes * ext * kTile + 2 * ext;
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

// kYPadded: I and p frames are (h + 4r, w) blocks whose rows are padded
template <bool kSelf, bool kYPadded>
__global__ void __launch_bounds__(kThreads)
guided_onepass_kernel(const float* __restrict__ I, int n_i,
                      const float* __restrict__ p, int n, int h, int w, int r,
                      float eps, float* __restrict__ q) {
  extern __shared__ float smem[];
  const int ksz = 2 * r + 1;
  const int ext = kTile + 4 * r, rab = kTile + 2 * r;
  const int nplanes = kSelf ? 2 : 4;
  float* EI = smem;                                // ext x ext
  float* EP = kSelf ? EI : EI + ext * ext;         // ext x ext (general)
  float* X = EI + (kSelf ? 1 : 2) * ext * ext;     // nplanes of ext x rab
  float* A = X + nplanes * ext * rab;              // rab x rab
  float* B = A + rab * rab;                        // rab x rab
  int* YS = reinterpret_cast<int*>(B + rab * rab); // ext reflected rows
  int* XS = YS + ext;                              // ext reflected columns
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  // the same f32 coefficient as the host's float32(1.0 / ksz^2)
  const float coef = static_cast<float>(1.0 / (ksz * ksz));
  const int hin = kYPadded ? h + 4 * r : h;  // rows of a source frame
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t in_plane = static_cast<size_t>(hin) * w;
  if (kYPadded) {
    clamped_table(y0, ext, hin, YS);
  } else {
    reflect101_table(y0 - 2 * r, ext, h, YS);
  }
  reflect101_table(x0 - 2 * r, ext, w, XS);
  __syncthreads();

  for (int z = blockIdx.z; z < n; z += gridDim.z) {
    stage_rows(I + (z % n_i) * in_plane, w, YS, ext, XS, ext, EI);
    if (!kSelf) stage_rows(p + z * in_plane, w, YS, ext, XS, ext, EP);
    __syncthreads();

    // 1. row window sums over ext x rab: X[k][row][col] sums E[row][col..+2r]
    const int xplane = ext * rab;
    for (int i = tid; i < xplane; i += kThreads) {
      const int row = i / rab, col = i - row * rab;
      const float* ip = EI + row * ext + col;
      if (kSelf) {
        float si = ip[0], sii = __fmul_rn(ip[0], ip[0]);
        for (int k = 1; k < ksz; ++k) {
          si = __fadd_rn(si, ip[k]);
          sii = __fadd_rn(sii, __fmul_rn(ip[k], ip[k]));
        }
        X[i] = si;
        X[xplane + i] = sii;
      } else {
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
    }
    __syncthreads();

    // 2. column window sums over rab x rab, then a and b
    for (int i = tid; i < rab * rab; i += kThreads) {
      const int row = i / rab, col = i - row * rab;
      const int j0 = row * rab + col;
      if (kSelf) {
        float si = X[j0], sii = X[xplane + j0];
        for (int k = 1; k < ksz; ++k) {
          const int j = j0 + k * rab;
          si = __fadd_rn(si, X[j]);
          sii = __fadd_rn(sii, X[xplane + j]);
        }
        ab_of(si, si, sii, sii, coef, eps, A + i, B + i);
      } else {
        float si = X[j0], sp = X[xplane + j0];
        float sip = X[2 * xplane + j0], sii = X[3 * xplane + j0];
        for (int k = 1; k < ksz; ++k) {
          const int j = j0 + k * rab;
          si = __fadd_rn(si, X[j]);
          sp = __fadd_rn(sp, X[xplane + j]);
          sip = __fadd_rn(sip, X[2 * xplane + j]);
          sii = __fadd_rn(sii, X[3 * xplane + j]);
        }
        ab_of(si, sp, sip, sii, coef, eps, A + i, B + i);
      }
    }
    __syncthreads();

    // 3. row window sums of a and b over rab x kTile, into X
    const int abplane = rab * kTile;
    for (int i = tid; i < abplane; i += kThreads) {
      const int row = i / kTile, col = i - row * kTile;
      const float* ap = A + row * rab + col;
      const float* bp = B + row * rab + col;
      float sa = ap[0], sb = bp[0];
      for (int k = 1; k < ksz; ++k) {
        sa = __fadd_rn(sa, ap[k]);
        sb = __fadd_rn(sb, bp[k]);
      }
      X[i] = sa;
      X[abplane + i] = sb;
    }
    __syncthreads();

    // 4. column window sums of a and b, then q; I at the tile centre
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int row = i / kTile, col = i - row * kTile;
      const int y = y0 + row, x = x0 + col;
      if (y >= h || x >= w) continue;
      float sa = X[i], sb = X[abplane + i];
      for (int k = 1; k < ksz; ++k) {
        sa = __fadd_rn(sa, X[i + k * kTile]);
        sb = __fadd_rn(sb, X[abplane + i + k * kTile]);
      }
      const float ic = EI[(row + 2 * r) * ext + col + 2 * r];
      q[z * plane + static_cast<size_t>(y) * w + x] = q_of(sa, sb, ic, coef);
    }
    __syncthreads();  // shared memory is refilled for the next frame
  }
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();  // clear it; returned below
  return err;
}

bool bad_args(int n_i, int n, int h, int w, int r) {
  return r < 1 || r > kMaxRadius || n_i < 1 || n < 1 || n % n_i != 0 ||
         h < 1 || w < 1;
}

dim3 grid_of(int n, int h, int w) {
  return dim3((w + kTile - 1) / kTile, (h + kTile - 1) / kTile,
              n < 65535 ? n : 65535);
}

template <bool kSelf, bool kYPadded>
int launch_onepass(const float* I, int n_i, const float* p, int n, int h,
                   int w, int r, float eps, float* q, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(onepass_smem_words(r, kSelf)) * 4;
  const cudaError_t err =
      allow_smem(guided_onepass_kernel<kSelf, kYPadded>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  guided_onepass_kernel<kSelf, kYPadded>
      <<<grid_of(n, h, w), kThreads, bytes, stream>>>(I, n_i, p, n, h, w, r,
                                                      eps, q);
  return static_cast<int>(cudaGetLastError());
}

template <bool kYPadded>
int onepass(const float* I, int n_i, const float* p, int n, int h, int w,
            int r, float eps, int self_guided, float* q,
            cudaStream_t stream) {
  if (bad_args(n_i, n, h, w, r) || (self_guided && n != n_i)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return self_guided
             ? launch_onepass<true, kYPadded>(I, n_i, I, n, h, w, r, eps, q,
                                              stream)
             : launch_onepass<false, kYPadded>(I, n_i, p, n, h, w, r, eps, q,
                                               stream);
}

}  // namespace

// I: n_i frames of (h, w) float32; p, q: n frames, n a multiple of n_i, and
// p frame z is guided by I frame z mod n_i. self_guided: p is I (p unused,
// n == n_i). All contiguous.
extern "C" int tpuimg_guided_onepass(const float* I, int n_i, const float* p,
                                     int n, int h, int w, int r, float eps,
                                     int self_guided, float* q,
                                     cudaStream_t stream) {
  return onepass<false>(I, n_i, p, n, h, w, r, eps, self_guided, q, stream);
}

// As tpuimg_guided_onepass, with I and p frames of (h + 4r, w): rows padded
// by 2r on each side; q is (h, w) frames.
extern "C" int tpuimg_guided_onepass_ypadded(const float* I, int n_i,
                                             const float* p, int n, int h,
                                             int w, int r, float eps,
                                             int self_guided, float* q,
                                             cudaStream_t stream) {
  return onepass<true>(I, n_i, p, n, h, w, r, eps, self_guided, q, stream);
}

// As tpuimg_guided_onepass, general only; a, b: n frames of scratch.
extern "C" int tpuimg_guided_twopass(const float* I, int n_i, const float* p,
                                     int n, int h, int w, int r, float eps,
                                     float* a, float* b, float* q,
                                     cudaStream_t stream) {
  if (bad_args(n_i, n, h, w, r)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes_ab = static_cast<size_t>(twopass_smem_words(r, 4)) * 4;
  const size_t bytes_q = static_cast<size_t>(twopass_smem_words(r, 2)) * 4;
  cudaError_t err = allow_smem(guided_ab_kernel, bytes_ab);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(guided_q_kernel, bytes_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = grid_of(n, h, w);
  guided_ab_kernel<<<grid, kThreads, bytes_ab, stream>>>(I, n_i, p, n, h, w,
                                                         r, eps, a, b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  guided_q_kernel<<<grid, kThreads, bytes_q, stream>>>(I, n_i, a, b, n, h, w,
                                                       r, q);
  return static_cast<int>(cudaGetLastError());
}
