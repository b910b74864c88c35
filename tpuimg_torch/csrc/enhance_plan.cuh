// What the enhance pipeline's plan (enhance_plan.cu) shares with the kernel
// sources it launches: the tail's taps, a configured launch, and the halves
// that each source's launch helper is split into. A "configure" half makes
// the CUDA queries and the shared-memory attribute call and fixes the grid;
// a "launch" half queues the kernel from that alone. The stand-alone C
// entries call both halves on every call; a plan calls the configure halves
// once and the launch halves on every frame, so both take their launch
// geometry from the same code.
#pragma once

#include <atomic>
#include <cstdint>

#include "common.cuh"

constexpr int kMaxTaps = 33;  // gaussian radius <= 16

// the taps travel by value in the launch's parameter space: no device
// buffer, no host-to-device copy before the launch
struct Taps {
  float w[kMaxTaps];
};

// One configured launch: the kernel instance (as the runtime names it, for
// its attributes), its grid, the rows a block takes, its dynamic shared
// memory, and which instance the launch half queues (numbered by the source
// that configured it).
struct Launch {
  const void* kernel;
  dim3 grid;
  int rows;
  int bytes;
  int route;
};

// The tail's two walks (enhance_tail.cuh): walk 1 makes a and b, walk 2 q.
struct TailPlan {
  Launch walk1, walk2;
};

// Counts the calls that set the dynamic shared-memory ceiling of a kernel
// that a plan launches. The ceiling is the card's, one for every caller: a
// stand-alone entry's call, or another plan's configuring, may set it below
// what a plan needs, so a plan that finds the count moved raises its own
// ceilings again before it launches.
inline std::atomic<unsigned> smem_epoch{0};

inline void smem_ceiling_set() {
  smem_epoch.fetch_add(1, std::memory_order_acq_rel);
}

// clahe_map.cu: the mapping of rows [y0, y0 + h) (out_f32: the blend times
// scale; else u8)
int clahe_map_configure(int h, int w, int xtiles, float inv_tw, bool out_f32,
                        Launch* c);
int clahe_map_launch(const Launch& c, const uint8_t* img, int h, int w,
                     int y0, const ClaheGeom& g, float scale, void* out,
                     cudaStream_t stream);

// enhance_tail.cu (f a float32 frame) and enhance_tail_clahe.cu (f the CLAHE
// blend of a u8 frame times scale): the tail's two walks, u8 q
int enhance_tail_configure(int h, int w, int rg, int r, TailPlan* p);
int enhance_tail_launch(const TailPlan& p, const float* f, int h, int w,
                        const Taps& taps, int rg, int r, float eps,
                        float* scratch, uint8_t* out, cudaStream_t stream);
int enhance_tail_clahe_configure(int h, int w, int rg, int r, TailPlan* p);
int enhance_tail_clahe_launch(const TailPlan& p, const uint8_t* img, int h,
                              int w, const ClaheGeom& g, float scale,
                              const Taps& taps, int rg, int r, float eps,
                              float* scratch, uint8_t* out,
                              cudaStream_t stream);

// tile_hist.cu: the tile kernel ending in CLAHE's tables (no query to make)
extern "C" int tpuimg_tile_tables(const uint8_t* img, int h, int w,
                                  int ytiles, int xtiles, int th, int tw,
                                  int pad_top, int pad_left, int cluster,
                                  int rows, int limit, float fr, float* out,
                                  cudaStream_t stream);
