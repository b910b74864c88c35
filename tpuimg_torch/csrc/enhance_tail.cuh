// The enhance pipeline's tail: q = guided(I=f, p=gaussian(f, rg), r, eps),
// reflect-101 borders, 1/ksz^2 normalisation, in one launch, templated on
// the producer of f. enhance_tail.cu reads f from a float32 frame;
// enhance_tail_clahe.cu computes it from the u8 frame through the CLAHE
// blend. Both instantiate this one body, so their tail arithmetic is the
// same code.
//
// The algebra is tpuimg/kernels/boxsum.py::_tail_chain's: on an extent with
// a halo of depth hb2 = 2r + rg, smooth the frame with the separable
// gaussian (down the columns, then along the rows), take the four box means
// of I, S, I*S and I*I over the (tile + 2r) extent, form a = (mean_IS -
// mean_S*mean_I) / (mean_II - mean_I^2 + eps) and b = mean_S - a*mean_I,
// box-sum a and b over the tile and emit q = (sum_a*I + sum_b) / ksz^2. The
// smoothed frame is recomputed on the halo and never reaches device memory.
//
// Design on this card: one block per 32x32 output tile loads its
// (32 + 2*hb2)^2 input extent into shared memory, mapping each coordinate
// through reflect-101 once, so the frame is never padded in device memory.
// Every later stage reads and writes shared memory only:
//   F (extent) -> T (column pass of the gaussian) -> S (smooth)
//   -> X (row window sums of I, S, I*S, I*I) -> T (a | b)
//   -> X (row window sums of a, b) -> q in device memory.
// Bound: shared-memory traffic. Each output pixel costs a few hundred
// shared loads (window sums are direct (2r+1)-tap loops; r = 8 gives 17),
// against 8 bytes of device memory (4 in, 4 out, plus the halo re-read,
// which hits L2). The TPU's column strips, VMEM band budgets and (8, 128)
// padding have no counterpart. Shared memory per block is about 100 KB at
// r = 8, rg = 2 (two blocks per SM); above 48 KB it needs the
// cudaFuncSetAttribute call below, and a radius whose extent passes the
// 227 KB limit fails that call and is reported as a launch error.
#pragma once

#include "common.cuh"

constexpr int kMaxTaps = 33;  // gaussian radius <= 16

// the taps travel by value in the launch's parameter space: no device
// buffer, no host-to-device copy before the launch
struct Taps {
  float w[kMaxTaps];
};

namespace tail {

constexpr int kTile = 32;
constexpr int kThreads = 256;

struct TailGeom {
  int hb2, eh, ro, rab, tsz;
  __host__ __device__ TailGeom(int rg, int r)
      : hb2(2 * r + rg),
        eh(kTile + 2 * (2 * r + rg)),
        ro(kTile + 4 * r),
        rab(kTile + 2 * r),
        tsz(ro * eh > 2 * rab * rab ? ro * eh : 2 * rab * rab) {}
  // F + T + S + X + taps, in floats
  __host__ __device__ int floats(int rg) const {
    return eh * eh + tsz + ro * ro + 4 * ro * rab + 2 * rg + 1;
  }
};

// src(y, x) is f at the in-frame pixel (y, x)
template <class Src>
__global__ void __launch_bounds__(kThreads)
tail_kernel(const Src src, int h, int w, const Taps taps, int rg, int r,
            float eps, float* __restrict__ q) {
  extern __shared__ float smem[];
  const TailGeom g(rg, r);
  const int ksz = 2 * r + 1;
  const int ew = g.eh, ro = g.ro, wo = g.ro, rab = g.rab, wab = g.rab;
  float* F = smem;                // eh x ew: input extent
  float* T = F + g.eh * ew;       // ro x ew: column pass; later a | b
  float* S = T + g.tsz;           // ro x wo: smooth
  float* X = S + ro * wo;         // 4 planes of ro x wab; later 2 of rab x kTile
  float* W = X + 4 * ro * wab;    // 2rg + 1 gaussian taps
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  // the same f32 coefficient as the host's float32(1.0 / ksz^2)
  const float coef = static_cast<float>(1.0 / (ksz * ksz));

  // 1. extent, reflect-101 mapped; coordinates past the mirror range only
  //    feed outputs beyond the frame, which are not stored, so clamp them
  for (int i = tid; i < g.eh * ew; i += kThreads) {
    const int ey = i / ew, ex = i - ey * ew;
    const int y = min(max(reflect101(y0 - g.hb2 + ey, h), 0), h - 1);
    const int x = min(max(reflect101(x0 - g.hb2 + ex, w), 0), w - 1);
    F[i] = src(y, x);
  }
  for (int i = tid; i < 2 * rg + 1; i += kThreads) W[i] = taps.w[i];
  __syncthreads();

  // 2. gaussian along columns: T[row][col] centred on F[row + rg][col]
  for (int i = tid; i < ro * ew; i += kThreads) {
    const int row = i / ew, col = i - row * ew;
    const float* c = F + (row + rg) * ew + col;
    float acc = W[rg] * c[0];
    for (int k = 1; k <= rg; ++k) acc += W[rg - k] * (c[-k * ew] + c[k * ew]);
    T[i] = acc;
  }
  __syncthreads();

  // 3. gaussian along rows: S[row][col] centred on T[row][col + rg]
  for (int i = tid; i < ro * wo; i += kThreads) {
    const int row = i / wo, col = i - row * wo;
    const float* c = T + row * ew + col + rg;
    float acc = W[rg] * c[0];
    for (int k = 1; k <= rg; ++k) acc += W[rg - k] * (c[-k] + c[k]);
    S[i] = acc;
  }
  __syncthreads();

  // 4. row window sums of I, S, I*S, I*I; I[row][col] = F[row + rg][col + rg]
  const int plane = ro * wab;
  for (int i = tid; i < plane; i += kThreads) {
    const int row = i / wab, col = i - row * wab;
    const float* ip = F + (row + rg) * ew + col + rg;
    const float* sp = S + row * wo + col;
    float si = 0.f, ss = 0.f, sis = 0.f, sii = 0.f;
    for (int k = 0; k < ksz; ++k) {
      const float a = ip[k], b = sp[k];
      si += a;
      ss += b;
      sis += a * b;
      sii += a * a;
    }
    X[i] = si;
    X[plane + i] = ss;
    X[2 * plane + i] = sis;
    X[3 * plane + i] = sii;
  }
  __syncthreads();

  // 5. column window sums -> the four means -> a, b over (rab x wab)
  float* A = T;
  float* B = T + rab * wab;
  for (int i = tid; i < rab * wab; i += kThreads) {
    const int row = i / wab, col = i - row * wab;
    float si = 0.f, ss = 0.f, sis = 0.f, sii = 0.f;
    for (int k = 0; k < ksz; ++k) {
      const int j = (row + k) * wab + col;
      si += X[j];
      ss += X[plane + j];
      sis += X[2 * plane + j];
      sii += X[3 * plane + j];
    }
    const float imu = si * coef, pmu = ss * coef;
    const float ipmu = sis * coef, iimu = sii * coef;
    const float a = (ipmu - pmu * imu) / (iimu - imu * imu + eps);
    A[i] = a;
    B[i] = pmu - a * imu;
  }
  __syncthreads();

  // 6. row window sums of a and b over (rab x kTile)
  const int abplane = rab * kTile;
  for (int i = tid; i < abplane; i += kThreads) {
    const int row = i / kTile, col = i - row * kTile;
    const float* ap = A + row * wab + col;
    const float* bp = B + row * wab + col;
    float sa = 0.f, sb = 0.f;
    for (int k = 0; k < ksz; ++k) {
      sa += ap[k];
      sb += bp[k];
    }
    X[i] = sa;
    X[abplane + i] = sb;
  }
  __syncthreads();

  // 7. column window sums of a and b, then q; I at the tile centre
  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int row = i / kTile, col = i - row * kTile;
    const int y = y0 + row, x = x0 + col;
    if (y >= h || x >= w) continue;
    float sa = 0.f, sb = 0.f;
    for (int k = 0; k < ksz; ++k) {
      const int j = (row + k) * kTile + col;
      sa += X[j];
      sb += X[abplane + j];
    }
    const float ic = F[(row + g.hb2) * ew + col + g.hb2];
    q[static_cast<size_t>(y) * w + x] = (sa * ic + sb) * coef;
  }
}

// One launch of tail_kernel<Src> on an (h, w) frame; taps.w[0 .. 2*rg] are
// the gaussian weights. Needs h, w > 2r + rg (the callers gate on
// min(h, w) > 2*(2r + rg)).
template <class Src>
int launch(const Src& src, int h, int w, const Taps& taps, int rg, int r,
           float eps, float* out, cudaStream_t stream) {
  if (rg < 0 || 2 * rg + 1 > kMaxTaps || r < 1 || h <= 2 * r + rg ||
      w <= 2 * r + rg) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TailGeom g(rg, r);
  const size_t bytes = static_cast<size_t>(g.floats(rg)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tail_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the caller gets the code
    return static_cast<int>(err);
  }
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  tail_kernel<Src><<<grid, kThreads, bytes, stream>>>(src, h, w, taps, rg, r,
                                                      eps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tail
