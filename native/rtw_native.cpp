// Native runtime for raytracingweekend_tpu.
//
// The reference implements its runtime in C++ (the render driver, PPM writer
// and ImageMagick shell-out at RayTracingWeekend/RayTracingWeekend.cpp:162-289);
// this library is the framework's native equivalent: image codecs
// (PNG/JPEG/PPM via libpng/libjpeg — including the image *decoder* the
// reference ships earth.jpg for but never wrote, texture.h:73-98) and a
// multithreaded accumulation framebuffer with checkpoint/resume, exposed
// through a plain C ABI for ctypes.
//
// Build: make -C native   (produces librtw_native.so). Where the libpng /
// libjpeg headers are missing, the Makefile builds with -DRTW_NO_CODECS:
// the PNG/JPEG entry points then fail with an error and rtw_has_codecs()
// returns 0; PPM and the framebuffer are unaffected.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#ifndef RTW_NO_CODECS
#include <jpeglib.h>
#include <png.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Error reporting: last error message per process (single-threaded callers).
// ---------------------------------------------------------------------------
static char g_err[512];

static void set_err(const char* msg) {
  std::snprintf(g_err, sizeof(g_err), "%s", msg);
}

const char* rtw_last_error() { return g_err; }

#ifndef RTW_NO_CODECS
int rtw_has_codecs() { return 1; }

// ---------------------------------------------------------------------------
// PNG write: 8-bit RGB, rows top-down.
// ---------------------------------------------------------------------------
int rtw_write_png(const char* path, const uint8_t* rgb, int w, int h) {
  FILE* f = std::fopen(path, "wb");
  if (!f) { set_err("fopen failed"); return -1; }
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    set_err("libpng init/encode failed");
    if (png) png_destroy_write_struct(&png, info ? &info : nullptr);
    std::fclose(f);
    return -1;
  }
  png_init_io(png, f);
  png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_RGB, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y)
    rows[y] = const_cast<png_bytep>(rgb + size_t(y) * w * 3);
  png_write_image(png, rows.data());
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// PNG read: any color type -> 8-bit RGB. Caller passes a buffer of
// w*h*3 bytes obtained after rtw_png_size.
// ---------------------------------------------------------------------------
int rtw_png_size(const char* path, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { set_err("fopen failed"); return -1; }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    set_err("libpng read init failed");
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    std::fclose(f);
    return -1;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  *w = int(png_get_image_width(png, info));
  *h = int(png_get_image_height(png, info));
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(f);
  return 0;
}

int rtw_read_png(const char* path, uint8_t* rgb, int w, int h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { set_err("fopen failed"); return -1; }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    set_err("libpng decode failed");
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    std::fclose(f);
    return -1;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  if (int(png_get_image_width(png, info)) != w ||
      int(png_get_image_height(png, info)) != h) {
    set_err("size mismatch");
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    return -1;
  }
  // Normalize to 8-bit RGB.
  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = rgb + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG read (baseline/progressive via libjpeg) -> 8-bit RGB.
// ---------------------------------------------------------------------------
int rtw_jpeg_size(const char* path, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { set_err("fopen failed"); return -1; }
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    set_err("jpeg header failed");
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -1;
  }
  *w = int(cinfo.image_width);
  *h = int(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

int rtw_read_jpeg(const char* path, uint8_t* rgb, int w, int h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { set_err("fopen failed"); return -1; }
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (int(cinfo.output_width) != w || int(cinfo.output_height) != h) {
    set_err("size mismatch");
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb + size_t(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

#else
int rtw_has_codecs() { return 0; }

static int no_codecs() {
  set_err("built without libpng/libjpeg (RTW_NO_CODECS)");
  return -1;
}
int rtw_write_png(const char*, const uint8_t*, int, int) { return no_codecs(); }
int rtw_png_size(const char*, int*, int*) { return no_codecs(); }
int rtw_read_png(const char*, uint8_t*, int, int) { return no_codecs(); }
int rtw_jpeg_size(const char*, int*, int*) { return no_codecs(); }
int rtw_read_jpeg(const char*, uint8_t*, int, int) { return no_codecs(); }
#endif  // RTW_NO_CODECS

// ---------------------------------------------------------------------------
// PPM write. P6 (binary, fast) and P3 (text, matches the reference's writer
// at RayTracingWeekend.cpp:252-277 byte-for-byte in content).
// ---------------------------------------------------------------------------
int rtw_write_ppm6(const char* path, const uint8_t* rgb, int w, int h) {
  FILE* f = std::fopen(path, "wb");
  if (!f) { set_err("fopen failed"); return -1; }
  std::fprintf(f, "P6\n%d %d\n255\n", w, h);
  size_t n = size_t(w) * h * 3;
  size_t wr = std::fwrite(rgb, 1, n, f);
  std::fclose(f);
  if (wr != n) { set_err("short write"); return -1; }
  return 0;
}

int rtw_write_ppm3(const char* path, const uint8_t* rgb, int w, int h) {
  FILE* f = std::fopen(path, "wb");
  if (!f) { set_err("fopen failed"); return -1; }
  std::fprintf(f, "P3\n%d %d\n255\n", w, h);
  for (size_t i = 0, n = size_t(w) * h; i < n; ++i) {
    const uint8_t* p = rgb + i * 3;
    std::fprintf(f, "%d %d %d\n", p[0], p[1], p[2]);
  }
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Accumulation framebuffer: float32 radiance sums + sample count, with
// multithreaded accumulate/resolve and checkpoint save/load. This is the
// native replacement for the reference's in-RAM canvas + final PPM dump
// (RayTracingWeekend.cpp:210,247,252-277) — but restartable.
// ---------------------------------------------------------------------------
struct RtwFb {
  int w = 0, h = 0;
  long long spp = 0;               // samples accumulated per pixel
  std::vector<float> acc;          // h*w*3 radiance sums
  std::mutex mu;
};

static unsigned hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? n : 4;
}

RtwFb* rtw_fb_create(int w, int h) {
  auto* fb = new RtwFb;
  fb->w = w;
  fb->h = h;
  fb->acc.assign(size_t(w) * h * 3, 0.0f);
  return fb;
}

void rtw_fb_destroy(RtwFb* fb) { delete fb; }

int rtw_fb_width(RtwFb* fb) { return fb->w; }
int rtw_fb_height(RtwFb* fb) { return fb->h; }
long long rtw_fb_spp(RtwFb* fb) { return fb->spp; }

// Add a chunk of radiance sums (h*w*3 float32, already summed over
// `chunk_spp` samples per pixel) into the accumulator. Multithreaded over
// row bands.
void rtw_fb_add(RtwFb* fb, const float* chunk, long long chunk_spp) {
  std::lock_guard<std::mutex> lock(fb->mu);
  size_t n = fb->acc.size();
  unsigned nt = std::min<unsigned>(hw_threads(), 16);
  if (n < (1u << 16)) nt = 1;
  std::vector<std::thread> ts;
  size_t per = (n + nt - 1) / nt;
  float* acc = fb->acc.data();
  for (unsigned t = 0; t < nt; ++t) {
    size_t lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([acc, chunk, lo, hi] {
      for (size_t i = lo; i < hi; ++i) acc[i] += chunk[i];
    });
  }
  for (auto& th : ts) th.join();
  fb->spp += chunk_spp;
}

// Resolve to 8-bit RGB: average, gamma-2 (sqrt), clamp, int(255.99*c) —
// exactly the reference's postprocess (RayTracingWeekend.cpp:241-244,268-270).
// `flip_rows` outputs row 0 at the image top given an accumulator whose row 0
// is the image bottom (the canvas convention).
void rtw_fb_resolve(RtwFb* fb, uint8_t* out, int flip_rows) {
  std::lock_guard<std::mutex> lock(fb->mu);
  float inv = fb->spp > 0 ? 1.0f / float(fb->spp) : 0.0f;
  int w = fb->w, h = fb->h;
  const float* acc = fb->acc.data();
  unsigned nt = std::min<unsigned>(hw_threads(), 16);
  std::vector<std::thread> ts;
  int per = (h + int(nt) - 1) / int(nt);
  for (unsigned t = 0; t < nt; ++t) {
    int y0 = int(t) * per, y1 = std::min(h, y0 + per);
    if (y0 >= y1) break;
    ts.emplace_back([=] {
      for (int y = y0; y < y1; ++y) {
        int oy = flip_rows ? (h - 1 - y) : y;
        const float* src = acc + size_t(y) * w * 3;
        uint8_t* dst = out + size_t(oy) * w * 3;
        for (int i = 0; i < w * 3; ++i) {
          float c = std::sqrt(std::max(src[i] * inv, 0.0f));
          c = std::min(c, 1.0f);
          int q = int(255.99f * c);
          dst[i] = uint8_t(q < 0 ? 0 : (q > 255 ? 255 : q));
        }
      }
    });
  }
  for (auto& th : ts) th.join();
}

// Checkpoint format: magic, w, h, spp, raw float32 accumulator.
static const uint32_t kFbMagic = 0x52545746;  // "RTWF"

int rtw_fb_save(RtwFb* fb, const char* path) {
  std::lock_guard<std::mutex> lock(fb->mu);
  FILE* f = std::fopen(path, "wb");
  if (!f) { set_err("fopen failed"); return -1; }
  uint32_t hdr[3] = {kFbMagic, uint32_t(fb->w), uint32_t(fb->h)};
  int64_t spp = fb->spp;
  bool ok = std::fwrite(hdr, sizeof(hdr), 1, f) == 1 &&
            std::fwrite(&spp, sizeof(spp), 1, f) == 1 &&
            std::fwrite(fb->acc.data(), sizeof(float), fb->acc.size(), f) ==
                fb->acc.size();
  std::fclose(f);
  if (!ok) { set_err("short write"); return -1; }
  return 0;
}

RtwFb* rtw_fb_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { set_err("fopen failed"); return nullptr; }
  uint32_t hdr[3];
  int64_t spp;
  if (std::fread(hdr, sizeof(hdr), 1, f) != 1 || hdr[0] != kFbMagic ||
      std::fread(&spp, sizeof(spp), 1, f) != 1) {
    set_err("bad checkpoint header");
    std::fclose(f);
    return nullptr;
  }
  auto* fb = rtw_fb_create(int(hdr[1]), int(hdr[2]));
  fb->spp = spp;
  if (std::fread(fb->acc.data(), sizeof(float), fb->acc.size(), f) !=
      fb->acc.size()) {
    set_err("truncated checkpoint");
    std::fclose(f);
    rtw_fb_destroy(fb);
    return nullptr;
  }
  std::fclose(f);
  return fb;
}

// Raw access for tests / interop (returns pointer to h*w*3 floats).
float* rtw_fb_data(RtwFb* fb) { return fb->acc.data(); }

}  // extern "C"
