// roomnet_io: native host data-plane for the TPU feed.
//
// The reference's hot host loop is cv2.imread -> crop -> cv2.resize per image
// on one producer thread (reference generator.py:95-112, 146-163). This
// library replaces it with a fused decode->crop->resize->flip pipeline:
//   * JPEG via libjpeg, PNG via libpng — ONLY these two formats; probe and
//     decode return 0 for anything else and the Python loader falls back to
//     cv2 per image (loader.py), so dataset coverage matches the cv2 path;
//   * header-only probe so the Python side can draw crop offsets without a
//     full decode (keeps RNG/augment semantics identical to the cv2 path);
//   * crop+resize fused: bilinear taps read the decoded image through the
//     crop window, no intermediate crop copy;
//   * flips fused into the output write;
//   * batch API with an internal thread pool writing one contiguous
//     B x S x S x 3 buffer (ready for jax.device_put, zero Python assembly).
//
// Pixel conventions match the Python/cv2 path: BGR channel order, uint8,
// half-pixel-centers bilinear (cv2 INTER_LINEAR; float arithmetic here, so
// outputs may differ from cv2's 11-bit fixed point by at most 1 LSB).
//
// Build: make -C csrc   (produces libroomnet_io.so; loaded via ctypes by
// roomnet_tpu/data/native.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------- decode --

struct Image {
  int h = 0, w = 0;            // decoded (possibly DCT-scaled) dims
  int orig_h = 0, orig_w = 0;  // pre-scale source dims, from the same
                               // header parse — callers mapping crop
                               // rects need both without a second open
  std::vector<uint8_t> bgr;    // h*w*3
};

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(FILE* f, Image* out, bool header_only, int min_decode_side) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  // Constructed BEFORE setjmp: a longjmp out of jpeg_read_scanlines must
  // not jump over a live std::vector (UB, and in practice a per-corrupt-
  // file leak of the row buffer). Declared here, row's destructor runs on
  // the normal function exit after the setjmp handler returns false.
  std::vector<uint8_t> row;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  out->h = out->orig_h = static_cast<int>(cinfo.image_height);
  out->w = out->orig_w = static_cast<int>(cinfo.image_width);
  if (header_only) {
    jpeg_destroy_decompress(&cinfo);
    return out->h > 0 && out->w > 0;
  }
  cinfo.out_color_space = JCS_RGB;
  if (min_decode_side > 0) {
    // DCT-domain scaled decode (libjpeg 1/2, 1/4, 1/8): pick the largest
    // reduction that keeps min(h,w) >= min_decode_side. ~4-8x faster than
    // full decode when the target is much smaller than the source — a
    // decoder capability cv2.imread cannot express (serving fast path).
    const int min_side = std::min(out->h, out->w);
    int denom = 1;
    while (denom < 8 && min_side / (denom * 2) >= min_decode_side) denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = static_cast<unsigned>(denom);
  }
  jpeg_start_decompress(&cinfo);
  const int w = static_cast<int>(cinfo.output_width);
  const int h = static_cast<int>(cinfo.output_height);
  out->h = h;
  out->w = w;
  out->bgr.resize(static_cast<size_t>(h) * w * 3);
  row.resize(static_cast<size_t>(w) * cinfo.output_components);
  uint8_t* rowp = row.data();
  for (int y = 0; y < h; ++y) {
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    uint8_t* dst = out->bgr.data() + static_cast<size_t>(y) * w * 3;
    if (cinfo.output_components == 3) {
      for (int x = 0; x < w; ++x) {  // RGB -> BGR
        dst[3 * x + 0] = row[3 * x + 2];
        dst[3 * x + 1] = row[3 * x + 1];
        dst[3 * x + 2] = row[3 * x + 0];
      }
    } else {  // grayscale
      for (int x = 0; x < w; ++x) {
        dst[3 * x + 0] = dst[3 * x + 1] = dst[3 * x + 2] = row[x];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(FILE* f, Image* out, bool header_only) {
  png_byte sig[8];
  if (fread(sig, 1, 8, f) != 8 || png_sig_cmp(sig, 0, 8)) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  // Before setjmp, same reasoning as decode_jpeg's row buffer.
  std::vector<uint8_t> row;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  out->h = out->orig_h = static_cast<int>(png_get_image_height(png, info));
  out->w = out->orig_w = static_cast<int>(png_get_image_width(png, info));
  if (header_only) {
    png_destroy_read_struct(&png, &info, nullptr);
    return out->h > 0 && out->w > 0;
  }
  // Normalize to 8-bit RGB.
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  const int h = out->h, w = out->w;
  out->bgr.resize(static_cast<size_t>(h) * w * 3);
  row.resize(png_get_rowbytes(png, info));
  for (int y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    uint8_t* dst = out->bgr.data() + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {  // RGB -> BGR
      dst[3 * x + 0] = row[3 * x + 2];
      dst[3 * x + 1] = row[3 * x + 1];
      dst[3 * x + 2] = row[3 * x + 0];
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_any(const char* path, Image* out, bool header_only,
                int min_decode_side = 0) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out, header_only, min_decode_side);
  } else if (n >= 8 && magic[0] == 0x89 && magic[1] == 'P') {
    ok = decode_png(f, out, header_only);  // PNG: no scaled decode
  }
  fclose(f);
  return ok;
}

// ---------------------------------------------------------- crop+resize --

// Fused crop->bilinear resize (half-pixel centers, cv2 INTER_LINEAR float
// equivalent) -> optional flips -> BGR uint8 out[side*side*3].
//
// Two-pass separable structure for auto-vectorization: the vertical lerp
// runs over the contiguous crop row (unit stride, SIMD-friendly); the
// horizontal taps then gather from the small interpolated buffer.
void crop_resize_flip(const Image& im, int cx, int cy, int cw, int ch,
                      int out_side, int flip_lr, int flip_ud, uint8_t* out) {
  const int S = out_side;
  const float sx = static_cast<float>(cw) / S;
  const float sy = static_cast<float>(ch) / S;
  std::vector<int> x0(S), x1(S);
  std::vector<float> fx(S);
  for (int i = 0; i < S; ++i) {
    float src = (i + 0.5f) * sx - 0.5f;
    src = std::min(std::max(src, 0.0f), static_cast<float>(cw - 1));
    int lo = static_cast<int>(src);
    x0[i] = lo * 3;  // offsets into the vrow buffer (crop-local, BGR triples)
    x1[i] = std::min(lo + 1, cw - 1) * 3;
    fx[i] = src - lo;
  }
  const int rowlen = cw * 3;
  std::vector<float> vrow(rowlen);  // vertically interpolated crop row
  for (int j = 0; j < S; ++j) {
    float src = (j + 0.5f) * sy - 0.5f;
    src = std::min(std::max(src, 0.0f), static_cast<float>(ch - 1));
    int lo = static_cast<int>(src);
    const int y0 = cy + lo;
    const int y1 = cy + std::min(lo + 1, ch - 1);
    const float fy = src - lo;
    const uint8_t* r0 =
        im.bgr.data() + (static_cast<size_t>(y0) * im.w + cx) * 3;
    const uint8_t* r1 =
        im.bgr.data() + (static_cast<size_t>(y1) * im.w + cx) * 3;
    // Pass 1: vertical lerp across the whole crop row — unit stride,
    // auto-vectorizes under -O3 -march=native.
    const float w0 = 1.0f - fy;
    for (int k = 0; k < rowlen; ++k) {
      vrow[k] = w0 * r0[k] + fy * r1[k];
    }
    // Pass 2: horizontal taps from the interpolated row.
    const int oj = flip_ud ? (S - 1 - j) : j;
    uint8_t* orow = out + static_cast<size_t>(oj) * S * 3;
    for (int i = 0; i < S; ++i) {
      const int oi = flip_lr ? (S - 1 - i) : i;
      uint8_t* opx = orow + oi * 3;
      const float f = fx[i];
      const float g = 1.0f - f;
      const float* p0 = vrow.data() + x0[i];
      const float* p1 = vrow.data() + x1[i];
      for (int c = 0; c < 3; ++c) {
        float v = g * p0[c] + f * p1[c];
        opx[c] = static_cast<uint8_t>(std::min(std::max(v + 0.5f, 0.0f), 255.0f));
      }
    }
  }
}

}  // namespace

// -------------------------------------------------------------- C API ----

extern "C" {

// Header-only probe: fills h/w without a full decode. Returns 1 on success.
int rn_probe(const char* path, int* h, int* w) {
  Image im;
  if (!decode_any(path, &im, /*header_only=*/true)) return 0;
  *h = im.h;
  *w = im.w;
  return 1;
}

// Decode + crop window (cx,cy,cw,ch) + resize to out_side + flips.
// crop values of (-1,...) mean "full image". Returns 1 on success.
// min_decode_side > 0 enables DCT-scaled JPEG decode (serving fast path);
// crop coords are in ORIGINAL image space and are rescaled to the decoded
// resolution (probe() reports original dims).
int rn_load_preprocess_scaled(const char* path, int cx, int cy, int cw,
                              int ch, int out_side, int flip_lr, int flip_ud,
                              int min_decode_side, uint8_t* out) {
  Image im;
  if (!decode_any(path, &im, /*header_only=*/false, min_decode_side)) return 0;
  // The decode records pre-scale dims from its own header parse, so the
  // caller's crop rect (original-image space) rescales without a second
  // fopen+header pass per image (the fast path exists for speed).
  const int orig_h = im.orig_h;
  const int orig_w = im.orig_w;
  if (cx < 0) {
    cx = 0;
    cy = 0;
    cw = orig_w;
    ch = orig_h;
  }
  if (im.w != orig_w || im.h != orig_h) {
    // Rescale the crop window into decoded coordinates.
    const double sx = static_cast<double>(im.w) / orig_w;
    const double sy = static_cast<double>(im.h) / orig_h;
    cx = static_cast<int>(cx * sx);
    cy = static_cast<int>(cy * sy);
    cw = std::max(1, static_cast<int>(cw * sx));
    ch = std::max(1, static_cast<int>(ch * sy));
    cw = std::min(cw, im.w - cx);
    ch = std::min(ch, im.h - cy);
  }
  if (cx + cw > im.w || cy + ch > im.h || cw <= 0 || ch <= 0) return 0;
  crop_resize_flip(im, cx, cy, cw, ch, out_side, flip_lr, flip_ud, out);
  return 1;
}

int rn_load_preprocess(const char* path, int cx, int cy, int cw, int ch,
                       int out_side, int flip_lr, int flip_ud, uint8_t* out) {
  return rn_load_preprocess_scaled(path, cx, cy, cw, ch, out_side, flip_lr,
                                   flip_ud, /*min_decode_side=*/0, out);
}

// Full decode into caller buffer (h*w*3 BGR); two-phase with rn_probe.
int rn_decode(const char* path, uint8_t* out, int h, int w) {
  Image im;
  if (!decode_any(path, &im, /*header_only=*/false)) return 0;
  if (im.h != h || im.w != w) return 0;
  std::memcpy(out, im.bgr.data(), im.bgr.size());
  return 1;
}

// Batch: n images -> contiguous out[n*side*side*3] using an internal thread
// pool. crops is n*4 ints (cx,cy,cw,ch; cx=-1 => full), flips is n*2 ints.
// ok[i] set to 1/0 per image. Returns the success count.
int rn_load_preprocess_batch(const char** paths, int n, const int* crops,
                             int out_side, const int* flips, uint8_t* out,
                             int* ok, int nthreads, int min_decode_side) {
  if (nthreads <= 0) nthreads = static_cast<int>(std::thread::hardware_concurrency());
  nthreads = std::max(1, std::min(nthreads, n));
  std::atomic<int> next(0), good(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      uint8_t* dst = out + static_cast<size_t>(i) * out_side * out_side * 3;
      const int r = rn_load_preprocess_scaled(
          paths[i], crops[4 * i], crops[4 * i + 1], crops[4 * i + 2],
          crops[4 * i + 3], out_side, flips[2 * i], flips[2 * i + 1],
          min_decode_side, dst);
      ok[i] = r;
      if (r) {
        good.fetch_add(1);
      } else {
        std::memset(dst, 0, static_cast<size_t>(out_side) * out_side * 3);
      }
    }
  };
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
  return good.load();
}

}  // extern "C"
