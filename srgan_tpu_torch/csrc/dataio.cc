// srgan_tpu_torch native image decoder (a copy of srgan_tpu/native/dataio.cc;
// host code, no device code).
//
// The reference feeds training through torch DataLoader workers doing PIL
// decode + crop + resize + per-image min-max (nb01 cells 9/18).  PIL holds the
// GIL through much of decode/resize, so thread workers don't scale.  This path
// does
//     decode (libpng/libjpeg) -> center crop -> PIL-parity triangle-filter
//     resize -> optional hflip -> per-image min-max to [-1, 1]
// directly into a caller-provided NHWC float32 buffer, with a std::thread
// pool for batches, behind a plain C ABI for ctypes
// (srgan_tpu_torch/data/native.py builds and binds it).
//
// Resize parity note: PIL's BILINEAR is a triangle filter with support
// scaled by the downscale factor (area-style antialiasing), NOT naive
// bilinear sampling; we implement the same algorithm in float.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

struct ImageU8 {
  std::vector<uint8_t> data;  // HWC, RGB
  int w = 0, h = 0;
};

// ---------------------------------------------------------------- decode

bool decode_png(FILE* f, ImageU8* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA || png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->w = static_cast<int>(w);
  out->h = static_cast<int>(h);
  out->data.resize(size_t(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out->data.data() + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jmp, 1);
}

bool decode_jpeg(FILE* f, ImageU8* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row =
        out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_file(const char* path, ImageU8* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[4] = {0};
  size_t got = fread(magic, 1, 4, f);
  rewind(f);
  bool ok = false;
  if (got == 4 && magic[0] == 0x89 && magic[1] == 'P')
    ok = decode_png(f, out);
  else if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8)
    ok = decode_jpeg(f, out);
  fclose(f);
  return ok;
}

// ----------------------------------------------- PIL-parity triangle resize

struct FilterTaps {
  std::vector<int> xmin, xlen;
  std::vector<float> weights;  // xlen-major, ksize stride
  int ksize = 0;
};

FilterTaps make_taps(int in_size, int out_size) {
  FilterTaps t;
  const double scale = double(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;  // bilinear support = 1
  t.ksize = int(std::ceil(support)) * 2 + 1;
  t.xmin.resize(out_size);
  t.xlen.resize(out_size);
  t.weights.assign(size_t(out_size) * t.ksize, 0.f);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = std::max(0, int(center - support + 0.5));
    int hi = std::min(in_size, int(center + support + 0.5));
    double sum = 0;
    std::vector<double> w(hi - lo);
    for (int x = lo; x < hi; ++x) {
      double arg = (x + 0.5 - center) / filterscale;
      double v = std::max(0.0, 1.0 - std::abs(arg));
      w[x - lo] = v;
      sum += v;
    }
    t.xmin[i] = lo;
    t.xlen[i] = hi - lo;
    for (int k = 0; k < hi - lo; ++k)
      t.weights[size_t(i) * t.ksize + k] = float(sum > 0 ? w[k] / sum : 0.0);
  }
  return t;
}

// crop (square, centered, PIL round-half rule) then resize to out x out.
void crop_resize_normalize(const ImageU8& img, int crop, int out_size,
                           bool flip, float* out) {
  const int left = int(std::lround((img.w - crop) / 2.0));
  const int top = int(std::lround((img.h - crop) / 2.0));
  auto px = [&](int y, int x, int c) -> float {
    y = std::min(std::max(y + top, 0), img.h - 1);
    x = std::min(std::max(x + left, 0), img.w - 1);
    return float(img.data[(size_t(y) * img.w + x) * 3 + c]);
  };

  const FilterTaps taps = make_taps(crop, out_size);
  // horizontal pass: crop x out_size
  std::vector<float> tmp(size_t(crop) * out_size * 3);
  for (int y = 0; y < crop; ++y)
    for (int i = 0; i < out_size; ++i) {
      float acc[3] = {0, 0, 0};
      const float* w = &taps.weights[size_t(i) * taps.ksize];
      for (int k = 0; k < taps.xlen[i]; ++k)
        for (int c = 0; c < 3; ++c) acc[c] += w[k] * px(y, taps.xmin[i] + k, c);
      for (int c = 0; c < 3; ++c)
        tmp[(size_t(y) * out_size + i) * 3 + c] = acc[c];
    }
  // vertical pass + flip + min-max
  float vmin = 1e30f, vmax = -1e30f;
  for (int j = 0; j < out_size; ++j)
    for (int i = 0; i < out_size; ++i) {
      float acc[3] = {0, 0, 0};
      const float* w = &taps.weights[size_t(j) * taps.ksize];
      for (int k = 0; k < taps.xlen[j]; ++k) {
        const float* row = &tmp[(size_t(taps.xmin[j] + k) * out_size + i) * 3];
        for (int c = 0; c < 3; ++c) acc[c] += w[k] * row[c];
      }
      const int oi = flip ? (out_size - 1 - i) : i;
      float* dst = &out[(size_t(j) * out_size + oi) * 3];
      for (int c = 0; c < 3; ++c) {
        dst[c] = acc[c] / 255.0f;
        vmin = std::min(vmin, dst[c]);
        vmax = std::max(vmax, dst[c]);
      }
    }
  // per-image min-max to [-1, 1] (the reference MinMax transform,
  // util.py:108-155: (x-min)/(max-min+1e-8)*2-1)
  const float inv = 1.0f / (vmax - vmin + 1e-8f);
  const size_t n = size_t(out_size) * out_size * 3;
  for (size_t i = 0; i < n; ++i) out[i] = (out[i] - vmin) * inv * 2.0f - 1.0f;
}

}  // namespace

extern "C" {

int srgan_load_image(const char* path, int crop, int out_size, int flip,
                     float* out) {
  ImageU8 img;
  if (!decode_file(path, &img)) return 1;
  crop_resize_normalize(img, crop, out_size, flip != 0, out);
  return 0;
}

// paths: n zero-terminated strings; flips: n bytes; out: n*out*out*3 floats.
int srgan_load_batch(const char** paths, int n, int crop, int out_size,
                     const unsigned char* flips, int num_threads, float* out) {
  std::atomic<int> next(0), errors(0);
  const size_t stride = size_t(out_size) * out_size * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      if (srgan_load_image(paths[i], crop, out_size, flips ? flips[i] : 0,
                           out + stride * i) != 0)
        errors.fetch_add(1);
    }
  };
  num_threads = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return errors.load();
}

}  // extern "C"
