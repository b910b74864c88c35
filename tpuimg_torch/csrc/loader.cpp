// tpuimg_torch native runtime: image decode/encode + threaded streaming
// prefetcher (the port's copy of the JAX package's native/loader.cpp).
//
// Role: the equivalent of the reference's host-side C++ layer. The
// reference's demos load frames synchronously through OpenCV on the host
// (e.g. Histogram/main.cpp:90, GaussianFilter/gaussian.cu:426); here the
// compute path is PyTorch and CUDA on the card, so the native layer's job is
// feeding it — decode on worker threads into a bounded ring of fixed-size
// frame slots so device transfers overlap decode. Exposed as a C ABI
// consumed via ctypes (tpuimg_torch/native.py).
//
// Build: tpuimg_torch/native.py builds it at first use (g++ -O2 -shared,
// links libpng16/libjpeg) into tpuimg_torch/_build/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

extern "C" {

// ---------------------------------------------------------------------------
// Single-image decode (PNG/JPEG by magic bytes). Returns 8-bit gray (want=1)
// or RGB (want=3). Two-call protocol: query dims, then fill caller's buffer.
// ---------------------------------------------------------------------------

struct DecodedImage {
  std::vector<uint8_t> data;
  int width = 0, height = 0, channels = 0;
};

}  // extern "C" (helpers below are C++-internal)

namespace {

bool decode_png(FILE* f, int want, DecodedImage* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  // constructed BEFORE setjmp: a libpng longjmp past a live vector's scope
  // would skip its destructor (UB + per-corrupt-file leak); here the jump
  // lands in-function and the destructor runs on return
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_set_strip_16(png);
  png_set_packing(png);
  int color = png_get_color_type(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY &&
      png_get_bit_depth(png, info) < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  if (want == 1)
    // Rec.601 luma (0.299 R + 0.587 G + 0.114 B) to match the cv2-based
    // utils.imread_gray path and libjpeg's JCS_GRAYSCALE; libpng's default
    // (-1, -1) would use Rec.709 weights (round-1 advisor finding)
    png_set_rgb_to_gray_fixed(png, 1, 29900, 58700);
  else if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_read_update_info(png, info);

  out->width = png_get_image_width(png, info);
  out->height = png_get_image_height(png, info);
  out->channels = want;
  size_t rowbytes = png_get_rowbytes(png, info);
  out->data.resize(rowbytes * out->height);
  rows.resize(out->height);
  for (int y = 0; y < out->height; ++y)
    rows[y] = out->data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jump, 1);
}

bool decode_jpeg(FILE* f, int want, DecodedImage* out) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = (want == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->width = cinfo.output_width;
  out->height = cinfo.output_height;
  out->channels = want;
  size_t rowbytes = size_t(out->width) * want;
  out->data.resize(rowbytes * out->height);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + cinfo.output_scanline * rowbytes;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_file(const char* path, int want, DecodedImage* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[2] = {0, 0};
  if (fread(magic, 1, 2, f) != 2) {
    fclose(f);
    return false;
  }
  rewind(f);
  bool ok = false;
  if (magic[0] == 0x89 && magic[1] == 'P')
    ok = decode_png(f, want, out);
  else if (magic[0] == 0xFF && magic[1] == 0xD8)
    ok = decode_jpeg(f, want, out);
  fclose(f);
  return ok;
}

bool read_dims_only(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[2] = {0, 0};
  if (fread(magic, 1, 2, f) != 2) {
    fclose(f);
    return false;
  }
  rewind(f);
  bool ok = false;
  if (magic[0] == 0x89 && magic[1] == 'P') {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    png_infop info = png ? png_create_info_struct(png) : nullptr;
    if (info && !setjmp(png_jmpbuf(png))) {
      png_init_io(png, f);
      png_read_info(png, info);
      *w = png_get_image_width(png, info);
      *h = png_get_image_height(png, info);
      ok = true;
    }
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
  } else if (magic[0] == 0xFF && magic[1] == 0xD8) {
    jpeg_decompress_struct cinfo;
    JpegErr err;
    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = jpeg_err_exit;
    if (!setjmp(err.jump)) {
      jpeg_create_decompress(&cinfo);
      jpeg_stdio_src(&cinfo, f);
      jpeg_read_header(&cinfo, TRUE);
      *w = cinfo.image_width;
      *h = cinfo.image_height;
      ok = true;
    }
    jpeg_destroy_decompress(&cinfo);
  }
  fclose(f);
  return ok;
}

}  // namespace

extern "C" {

// Query dims (header-only parse, no pixel decode): returns 0 on success.
int tpuimg_image_dims(const char* path, int want_channels, int* w, int* h) {
  (void)want_channels;
  return read_dims_only(path, w, h) ? 0 : -1;
}

// Decode into caller buffer of size w*h*want_channels; returns 0 on success.
int tpuimg_read_image(const char* path, int want_channels, uint8_t* buf,
                      int w, int h) {
  try {
    DecodedImage img;
    if (!decode_file(path, want_channels, &img)) return -1;
    if (img.width != w || img.height != h) return -2;
    memcpy(buf, img.data.data(), img.data.size());
    return 0;
  } catch (...) {  // exceptions must not cross the C ABI into ctypes
    return -3;
  }
}

int tpuimg_write_png(const char* path, const uint8_t* buf, int w, int h,
                     int channels) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  std::vector<png_bytep> rows;  // before setjmp (see decode_png)
  if (!info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_write_struct(&png, info ? &info : nullptr);
    fclose(f);
    return -1;
  }
  png_init_io(png, f);
  png_set_IHDR(png, info, w, h, 8,
               channels == 1 ? PNG_COLOR_TYPE_GRAY : PNG_COLOR_TYPE_RGB,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  rows.resize(h);
  for (int y = 0; y < h; ++y)
    rows[y] = const_cast<png_bytep>(buf + size_t(y) * w * channels);
  png_write_image(png, rows.data());
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Streaming prefetcher: worker threads decode (and nearest-neighbor
// stretch to the fixed slot size — anisotropic, aspect NOT preserved)
// ahead of the consumer through a bounded queue.
// ---------------------------------------------------------------------------

struct StreamItem {
  size_t idx;
  bool ok;
  std::vector<uint8_t> data;
};

struct Stream {
  std::vector<std::string> paths;
  int want = 1, slot_w = 0, slot_h = 0;
  size_t next_submit = 0;
  std::queue<StreamItem> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  size_t capacity = 4;
  std::vector<std::thread> workers;
  bool stop = false;
  size_t delivered = 0;
  int active_next = 0;  // readers inside tpuimg_stream_next
  std::condition_variable cv_idle;
  std::mutex submit_mu;

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::lock_guard<std::mutex> g(submit_mu);
        if (next_submit >= paths.size()) return;
        idx = next_submit++;
      }
      bool ok = false;
      std::vector<uint8_t> slot;
      try {  // an uncaught exception here (e.g. bad_alloc from a hostile
             // 60000x60000 header) would std::terminate the whole process;
             // report the frame as failed via the -(idx+2) protocol instead
        DecodedImage img;
        slot.assign(size_t(slot_w) * slot_h * want, 0);
        ok = decode_file(paths[idx].c_str(), want, &img);
        if (ok) {
          // nearest-neighbor stretch to the fixed slot (static shapes for
          // XLA; anisotropic — aspect is NOT preserved)
          for (int y = 0; y < slot_h; ++y) {
            int sy = std::min(int(int64_t(y) * img.height / slot_h),
                              img.height - 1);
            for (int x = 0; x < slot_w; ++x) {
              int sx = std::min(int(int64_t(x) * img.width / slot_w),
                                img.width - 1);
              for (int c = 0; c < want; ++c)
                slot[(size_t(y) * slot_w + x) * want + c] =
                    img.data[(size_t(sy) * img.width + sx) * want + c];
            }
          }
        }
      } catch (...) {
        ok = false;
        slot.clear();
      }
      std::unique_lock<std::mutex> g(mu);
      cv_space.wait(g, [&] { return ready.size() < capacity || stop; });
      if (stop) return;
      ready.push(StreamItem{idx, ok, std::move(slot)});
      cv_ready.notify_one();
    }
  }
};

void* tpuimg_stream_open(const char** paths, int n, int want_channels,
                         int slot_w, int slot_h, int nthreads, int capacity) {
  auto* s = new Stream();
  s->paths.assign(paths, paths + n);
  s->want = want_channels;
  s->slot_w = slot_w;
  s->slot_h = slot_h;
  s->capacity = capacity > 0 ? capacity : 4;
  int nt = nthreads > 0 ? nthreads : 2;
  for (int i = 0; i < nt; ++i)
    s->workers.emplace_back(&Stream::worker, s);
  return s;
}

// Blocks until the next decoded frame is available; copies it into buf.
// Returns the frame index, -1 when the stream is exhausted, or
// -(index + 2) when that frame failed to decode (buf is untouched).
long tpuimg_stream_next(void* handle, uint8_t* buf) {
  auto* s = static_cast<Stream*>(handle);
  std::unique_lock<std::mutex> g(s->mu);
  if (s->stop || s->delivered >= s->paths.size()) return -1;
  s->active_next++;
  s->cv_ready.wait(g, [&] { return !s->ready.empty() || s->stop; });
  if (s->stop) {
    if (--s->active_next == 0) s->cv_idle.notify_all();
    return -1;
  }
  auto item = std::move(s->ready.front());
  s->ready.pop();
  s->delivered++;
  s->cv_space.notify_one();
  if (--s->active_next == 0) s->cv_idle.notify_all();
  g.unlock();
  if (!item.ok) return -long(item.idx) - 2;
  memcpy(buf, item.data.data(), item.data.size());
  return long(item.idx);
}

void tpuimg_stream_close(void* handle) {
  auto* s = static_cast<Stream*>(handle);
  {
    std::unique_lock<std::mutex> g(s->mu);
    s->stop = true;
    s->cv_space.notify_all();
    s->cv_ready.notify_all();
    // rendezvous with in-flight next() calls: deleting while a reader is
    // still blocked on (or waking from) cv_ready would destroy a mutex /
    // condvar in use (ctypes releases the GIL, so readers genuinely
    // overlap close)
    s->cv_idle.wait(g, [&] { return s->active_next == 0; });
  }
  for (auto& t : s->workers) t.join();
  delete s;
}

}  // extern "C"
