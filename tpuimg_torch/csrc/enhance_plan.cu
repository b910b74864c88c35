// The enhance pipeline as one C call a frame (kernels/enhance_plan.py).
//
// tpuimg_enhance_plan is called once per (device, frame shape, parameters):
// it runs the configure halves of the chain's launches (enhance_plan.cuh),
// which make every CUDA query and attribute call the stand-alone entries
// make on each call, and keeps their grids, rows and shared-memory bytes in
// an EnhancePlan that the caller's buffer holds. tpuimg_enhance_run then
// queues a frame's kernels back to back on one stream from that plan, with
// no allocation and no query: the tile kernel's CLAHE tables, then for
// impl="fused" the mapping (the f32 blend times 1/255) and the tail's two
// walks (4 kernels), for impl="fused1" the CLAHE-fused tail's two walks (3).
// Only a plan's first call, and a call after another caller may have
// lowered a kernel's shared-memory ceiling (smem_epoch), asks for the
// ceilings and raises them.
// The kernels, their instances and their grids are those of the
// stand-alone entries tpuimg_tile_tables, tpuimg_clahe_map(out_f32) and
// tpuimg_enhance_tail(_clahe)(out_u8), which call the same halves; the
// outputs are theirs bit for bit.
//
// Memory: one device workspace a call, which the caller allocates on the
// call's stream: the (ytiles*xtiles, 256) f32 tables, the blend (fused) and
// the tail's scratch, at the byte offsets the plan was given.
#include <new>

#include "enhance_plan.cuh"

namespace {

struct EnhancePlan {
  int fused1, h, w, ytiles, xtiles, th, tw, pad_top, pad_left, cluster,
      rows, limit;
  float fr, inv_tw, scale, eps;
  Taps taps;
  int rg, r;
  long long tables_at, blend_at, scratch_at;
  Launch map;  // fused only
  TailPlan tail;
  // smem_epoch when this plan's ceilings were last known to hold
  std::atomic<unsigned> epoch;
};

// Raise a kernel's dynamic shared-memory ceiling to what its launch takes,
// where a call since has set it lower; never lower it (another plan may
// need more).
int raise_ceiling(const Launch& c) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, c.kernel);
  if (err == cudaSuccess && a.maxDynamicSharedSizeBytes < c.bytes) {
    err = cudaFuncSetAttribute(
        c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.bytes);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" long long tpuimg_enhance_plan_bytes() {
  return static_cast<long long>(sizeof(EnhancePlan));
}

// fused1: impl="fused1"; the frame (h, w), CLAHE's tile grid, its pads and
// tile_hist_plan's (cluster, rows), the clip limit in counts (at most
// th * tw) and the table scale fr; inv_tw the host's f32 1/tw; scale the
// f32 1/255 the blend is multiplied by; the tail's taps, gaussian radius
// rg, guided radius r and eps; the workspace's byte offsets; plan:
// tpuimg_enhance_plan_bytes() bytes, 8-byte aligned, which this fills.
// Returns the first CUDA error of the configuring.
extern "C" int tpuimg_enhance_plan(int fused1, int h, int w, int ytiles,
                                   int xtiles, int th, int tw, int pad_top,
                                   int pad_left, int cluster, int rows,
                                   int limit, float fr, float inv_tw,
                                   float scale, Taps taps, int rg, int r,
                                   float eps, long long tables_at,
                                   long long blend_at, long long scratch_at,
                                   void* plan) {
  auto* p = new (plan) EnhancePlan{};
  p->fused1 = fused1;
  p->h = h;
  p->w = w;
  p->ytiles = ytiles;
  p->xtiles = xtiles;
  p->th = th;
  p->tw = tw;
  p->pad_top = pad_top;
  p->pad_left = pad_left;
  p->cluster = cluster;
  p->rows = rows;
  p->limit = limit;
  p->fr = fr;
  p->inv_tw = inv_tw;
  p->scale = scale;
  p->eps = eps;
  p->taps = taps;
  p->rg = rg;
  p->r = r;
  p->tables_at = tables_at;
  p->blend_at = blend_at;
  p->scratch_at = scratch_at;
  // an epoch from before the configuring: the first run checks the
  // ceilings once, against whatever ran between
  p->epoch.store(smem_epoch.load() - 1);
  if (!fused1) {
    const int err = clahe_map_configure(h, w, xtiles, inv_tw, true, &p->map);
    if (err != 0) return err;
    return enhance_tail_configure(h, w, rg, r, &p->tail);
  }
  return enhance_tail_clahe_configure(h, w, rg, r, &p->tail);
}

// img: the (h, w) u8 frame; ws: the workspace (see tpuimg_enhance_plan);
// out: (h, w) u8, q as pipeline.py's _to_u8 rounds it.
extern "C" int tpuimg_enhance_run(void* plan, const uint8_t* img, void* ws,
                                  uint8_t* out, cudaStream_t stream) {
  auto* p = static_cast<EnhancePlan*>(plan);
  const unsigned now = smem_epoch.load();
  if (p->epoch.load() != now) {
    int err = p->fused1 ? 0 : raise_ceiling(p->map);
    if (err == 0) err = raise_ceiling(p->tail.walk1);
    if (err == 0) err = raise_ceiling(p->tail.walk2);
    if (err != 0) return err;
    p->epoch.store(now);
  }
  char* base = static_cast<char*>(ws);
  float* tables = reinterpret_cast<float*>(base + p->tables_at);
  float* scratch = reinterpret_cast<float*>(base + p->scratch_at);
  int err = tpuimg_tile_tables(img, p->h, p->w, p->ytiles, p->xtiles, p->th,
                               p->tw, p->pad_top, p->pad_left, p->cluster,
                               p->rows, p->limit, p->fr, tables, stream);
  if (err != 0) return err;
  const ClaheGeom g{tables,
                    p->ytiles,
                    p->xtiles,
                    static_cast<float>(p->th),
                    static_cast<float>(p->pad_top),
                    static_cast<float>(p->pad_left),
                    p->inv_tw};
  if (p->fused1) {
    return enhance_tail_clahe_launch(p->tail, img, p->h, p->w, g, p->scale,
                                     p->taps, p->rg, p->r, p->eps, scratch,
                                     out, stream);
  }
  float* blend = reinterpret_cast<float*>(base + p->blend_at);
  err = clahe_map_launch(p->map, img, p->h, p->w, 0, g, p->scale, blend,
                         stream);
  if (err != 0) return err;
  return enhance_tail_launch(p->tail, blend, p->h, p->w, p->taps, p->rg,
                             p->r, p->eps, scratch, out, stream);
}
