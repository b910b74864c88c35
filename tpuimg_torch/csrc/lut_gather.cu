// dst = table[img]: one 256-entry table for a frame, or one table per frame.
//
// Replaces tpuimg/kernels/lut.py::lut_gather (:77) and lut_gather_frames
// (:193). The TPU gathers with 128-lane dynamic-gathers from a table held in
// VMEM (u8 tables packed four entries to a word). Entries are copied as raw
// bytes or 4-byte words, never converted, so every bit of the selected entry
// arrives (a float32 table's -0.0 and NaN payloads included).
//
// Bound on this card: device memory, one byte read and one entry written a
// pixel (16.6 MB at 4K for a u8 table, 41.5 MB for a 4-byte one). The first
// design (four pixels a thread, 1,024 a block, each block staging its table
// and passing a barrier for them; a grid row a frame) took 0.0081 ms of
// device time at 4K for a u8 table and 0.0369 on 16 frames of 1080p, by the
// profiler. The u8 kernel (lut_gather_kernel, every table of a frame stack
// and one table of any frame) is redesigned:
// - A lane takes units of 16 pixels: one 16-byte load, 16 lookups, one
//   16-byte store. Units are aligned on the output, which the wrapper
//   allocates; the input may be an offset view, so a unit's bytes are cut
//   from the two aligned 16-byte words around them with funnel shifts (the
//   kernel is instanced on the offset's word, offset / 4). Both words hold
//   a byte of the unit, so no load leaves the input's 16-byte granules. The
//   last pixels, fewer than a unit, go one by one.
// - The table is replicated by lane, an entry a word (entry v of lane l's
//   copy at word v * 32 + l, 32 KB), so lane l reads only bank l and four
//   lookups are four shift-adds, four loads and three fixed byte permutes.
//   (Four entries a word, 8 KB, needed masks and byte selectors a lookup:
//   0.0078 ms at 4K against 0.0069; the lookups, not the bytes, set the
//   time: without them the kernel takes 0.0043.)
// - A grid of one wave (kernels/lut.py::lut_gather_plan): each block walks
//   a contiguous range of 16-pixel chunks of the flat (frames x n) pixels,
//   kChunks at a time (32 pixels a thread), issues a step's loads, and
//   stages a table only when its range enters another frame. A unit that is
//   not wholly in the staged frame (one that straddles two frames, or any
//   unit of frames smaller than kMinStagedPixels, which are never staged)
//   reads its entries through __ldg, its frame tracked pixel by pixel.
// Tables of 4-byte entries (one table for all the pixels: lut_gather_frames
// takes u8 tables only) keep the first design (lut_gather_words_kernel):
// the stores, four bytes a pixel, set their time, and every redesign tried
// was slower at 4K for a float32 table (device ms, against 0.0152): the u8
// kernel's walk with 16-byte stores of 16 pixels a lane, 0.0339 by events
// (a warp's stores 64 bytes apart wrote half sectors); 4 pixels a lane,
// 0.0176-0.0194; a pixel a lane, 0.0178-0.0181; more blocks an SM spilled,
// 0.0184-0.0461.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // == 256 table entries: one each to stage
constexpr int kChunk = 16;     // pixels: a lane's unit of the u8 kernel
// chunks a block of the u8 kernel takes at a time (kernels/lut.py
// LUT_ITER_CHUNKS): 2 units a thread
constexpr int kChunks = 512;
// the u8 kernel's blocks an SM, all resident (kernels/lut.py
// LUT_BLOCKS_PER_SM)
constexpr int kBlocksPerSm = 4;
// frames with fewer pixels are looked up through __ldg, never staged
constexpr long long kMinStagedPixels = 1 << 16;
// pixels a thread of the 4-byte kernel maps, 256 apart
constexpr int kWordItems = 4;

// the 16 bytes at img + i (i a multiple of 16), from the aligned 16-byte
// words at and after them: img % 16 = 4 * kQ + sh / 8
template <int kQ>
__device__ __forceinline__ uint4 load16(const uint8_t* p, int sh) {
  const uint4* a = reinterpret_cast<const uint4*>(
      reinterpret_cast<uintptr_t>(p) & ~static_cast<uintptr_t>(15));
  const uint4 lo = __ldg(a);
  if (kQ == 0 && sh == 0) return lo;
  const uint4 hi = __ldg(a + 1);
  const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  return make_uint4(__funnelshift_r(w[kQ], w[kQ + 1], sh),
                    __funnelshift_r(w[kQ + 1], w[kQ + 2], sh),
                    __funnelshift_r(w[kQ + 2], w[kQ + 3], sh),
                    __funnelshift_r(w[kQ + 3], w[kQ + 4], sh));
}

// four u8 entries for the four pixels of word x, from the table of
// widened entries (t = tab + lane; entry v at t[v * 32])
__device__ __forceinline__ unsigned look4(const unsigned* t, unsigned x) {
  const unsigned w0 = t[(x & 0xFFu) << 5];
  const unsigned w1 = t[((x >> 8) & 0xFFu) << 5];
  const unsigned w2 = t[((x >> 16) & 0xFFu) << 5];
  const unsigned w3 = t[(x >> 24) << 5];
  return __byte_perm(__byte_perm(w0, w1, 0x0040), __byte_perm(w2, w3, 0x0040),
                     0x5410);
}

// bytes e[k .. k + 3] as one little-endian word
__device__ __forceinline__ unsigned pack4(const unsigned* e, int k) {
  return e[k] | e[k + 1] << 8 | e[k + 2] << 16 | e[k + 3] << 24;
}

// the table in 32 copies, one a bank, an entry a word; every thread takes
// part
__device__ void stage(const uint8_t* table, uint8_t* raw, unsigned* tab) {
  __syncthreads();  // no thread still reads the table staged before
  raw[threadIdx.x] = table[threadIdx.x];  // kThreads == 256 entries
  __syncthreads();
  for (int i = threadIdx.x; i < 256 * 32; i += kThreads) tab[i] = raw[i >> 5];
  __syncthreads();
}

// Block b takes chunks [b * per_block, (b + 1) * per_block) of 16 pixels
// of the flat (frames x n) pixels, kChunks chunks at a time; frame f looks
// up tables + f * tstride (tstride 0: one table for all).
template <int kQ>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
lut_gather_kernel(const uint8_t* __restrict__ img, long long n,
                  long long total, const uint8_t* __restrict__ tables,
                  int tstride, long long per_block, int sh,
                  uint8_t* __restrict__ out) {
  constexpr int kUnits = kChunks / kThreads;  // a thread's, a step
  __shared__ uint8_t raw[256];
  __shared__ unsigned tab[256 * 32];
  const int tid = threadIdx.x;
  const unsigned* t = tab + (tid & 31);
  const long long chunks = (total + kChunk - 1) / kChunk;
  const long long c0 = static_cast<long long>(blockIdx.x) * per_block;
  const long long end = min(total, min(chunks, c0 + per_block) * kChunk);
  const bool staging = tstride == 0 || n >= kMinStagedPixels;
  long long staged = -1;  // the frame whose table is in tab
  long long lo = 0, hi = total;  // its pixels
  for (long long p0 = c0 * kChunk; p0 < end; p0 += kChunks * kChunk) {
    uint4 in[kUnits];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const long long i = p0 + static_cast<long long>(u * kThreads + tid) *
                                   kChunk;
      if (i + kChunk <= end) in[u] = load16<kQ>(img + i, sh);
    }
    // the step's loads are in flight while the table is staged
    if (staging) {
      const long long f = tstride == 0 ? 0 : p0 / n;
      if (f != staged) {
        stage(tables + f * tstride, raw, tab);
        staged = f;
        if (tstride != 0) lo = f * n, hi = lo + n;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const long long i = p0 + static_cast<long long>(u * kThreads + tid) *
                                   kChunk;
      if (i >= end) break;
      if (i + kChunk > end) {  // the last pixels, fewer than a unit
        long long f = tstride == 0 ? 0 : i / n;
        for (long long j = i; j < end; ++j) {
          if (tstride != 0 && j >= (f + 1) * n) ++f;
          out[j] = tables[f * tstride + img[j]];
        }
        continue;
      }
      uint4 r;
      if (staging && i >= lo && i + kChunk <= hi) {
        r = make_uint4(look4(t, in[u].x), look4(t, in[u].y),
                       look4(t, in[u].z), look4(t, in[u].w));
      } else {
        // straddles frames, or a frame too small to stage: each pixel's
        // own frame, from the frame of the unit's first
        long long f = tstride == 0 ? 0 : i / n;
        long long next = (f + 1) * n;
        unsigned e[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (tstride != 0 && i + j >= next) ++f, next += n;
          e[j] = __ldg(tables + f * tstride + byte_of(in[u], j));
        }
        r = make_uint4(pack4(e, 0), pack4(e, 4), pack4(e, 8), pack4(e, 12));
      }
      *reinterpret_cast<uint4*>(out + i) = r;
    }
  }
}

// One 4-byte-entry table for all the pixels: a block stages it and maps
// kThreads * kWordItems pixels, each thread kWordItems of them kThreads
// apart, so that every warp load and store is contiguous.
__global__ void __launch_bounds__(kThreads)
lut_gather_words_kernel(const uint8_t* __restrict__ img, long long total,
                        const unsigned* __restrict__ table,
                        unsigned* __restrict__ out) {
  __shared__ unsigned tab[256];
  tab[threadIdx.x] = table[threadIdx.x];
  __syncthreads();
  const long long i0 =
      static_cast<long long>(blockIdx.x) * (kThreads * kWordItems) +
      threadIdx.x;
  uint8_t v[kWordItems];
#pragma unroll
  for (int k = 0; k < kWordItems; ++k) {
    const long long i = i0 + k * kThreads;
    v[k] = i < total ? img[i] : 0;
  }
#pragma unroll
  for (int k = 0; k < kWordItems; ++k) {
    const long long i = i0 + k * kThreads;
    if (i < total) out[i] = tab[v[k]];
  }
}

}  // namespace

// img: (frames, n) u8, contiguous, at any offset; tables: 256 entries of
// elem_bytes each, frame f's at tables + f * tstride entries (tstride 0:
// one shared table). 1-byte entries: blocks of per_block chunks of 16
// pixels, blocks * per_block covering the frames
// (kernels/lut.py::lut_gather_plan). 4-byte entries: one table (tstride
// 0), the kernel's own grid. out: (frames, n) entries of elem_bytes,
// 16-byte aligned.
extern "C" int tpuimg_lut_gather(const uint8_t* img, long long n, int frames,
                                 const void* tables, int tstride,
                                 int elem_bytes, int blocks,
                                 long long per_block, void* out,
                                 cudaStream_t stream) {
  const long long total = n * frames;
  const long long chunks = (total + kChunk - 1) / kChunk;
  if (n < 1 || frames < 1 || blocks < 1 || per_block < 1 ||
      static_cast<long long>(blocks) * per_block < chunks ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (elem_bytes == 4 && tstride == 0) {
    const long long per = kThreads * kWordItems;
    lut_gather_words_kernel<<<static_cast<unsigned>((total + per - 1) / per),
                              kThreads, 0, stream>>>(
        img, total, static_cast<const unsigned*>(tables),
        static_cast<unsigned*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  if (elem_bytes != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(img) & 15);
  const int sh = 8 * (s & 3);
  const uint8_t* tab = static_cast<const uint8_t*>(tables);
  uint8_t* dst = static_cast<uint8_t*>(out);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (s >> 2) {
    case 0:
      lut_gather_kernel<0><<<grid, kThreads, 0, stream>>>(
          img, n, total, tab, tstride, per_block, sh, dst);
      break;
    case 1:
      lut_gather_kernel<1><<<grid, kThreads, 0, stream>>>(
          img, n, total, tab, tstride, per_block, sh, dst);
      break;
    case 2:
      lut_gather_kernel<2><<<grid, kThreads, 0, stream>>>(
          img, n, total, tab, tstride, per_block, sh, dst);
      break;
    default:
      lut_gather_kernel<3><<<grid, kThreads, 0, stream>>>(
          img, n, total, tab, tstride, per_block, sh, dst);
  }
  return static_cast<int>(cudaGetLastError());
}
