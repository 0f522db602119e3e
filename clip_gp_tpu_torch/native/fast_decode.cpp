// Fused JPEG decode → shortest-side bicubic resize → center crop.
//
// The host side of the data pipeline is the practical bottleneck once the
// frozen tower runs at >10k imgs/s per chip: PIL decodes the full-resolution
// JPEG and then resizes. This path instead uses libjpeg's DCT-domain scaling
// (decode directly at 1/2, 1/4, 1/8 scale — skipping most of the IDCT work
// for large photos), then a separable Catmull-Rom bicubic (a = -0.5, the same
// kernel family as PIL's BICUBIC) to the exact target, then center crop.
// Plain C ABI for ctypes; no Python API dependency; releases the GIL by
// construction (called via ctypes).
//
// Build: g++ -O3 -shared -fPIC fast_decode.cpp -ljpeg -o libfastdecode.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

#include <cstdio>  // jpeglib.h needs FILE
#include <dlfcn.h>
#include <jpeglib.h>

namespace {

// libjpeg-turbo partial-decompression entry points, resolved at runtime so
// the library still builds (and degrades to full decode) against a plain
// libjpeg that lacks them. With them, the train path decodes only the
// scanline/column window a RandomResizedCrop box actually reads.
typedef void (*crop_scanline_fn)(j_decompress_ptr, JDIMENSION*, JDIMENSION*);
typedef JDIMENSION (*skip_scanlines_fn)(j_decompress_ptr, JDIMENSION);

crop_scanline_fn get_crop_fn() {
  static crop_scanline_fn fn = reinterpret_cast<crop_scanline_fn>(
      dlsym(RTLD_DEFAULT, "jpeg_crop_scanline"));
  return fn;
}

skip_scanlines_fn get_skip_fn() {
  static skip_scanlines_fn fn = reinterpret_cast<skip_scanlines_fn>(
      dlsym(RTLD_DEFAULT, "jpeg_skip_scanlines"));
  return fn;
}

// set_partial_decode() toggles (exactness tests). Atomic: the toggle may be
// written while BatchLoader pool workers are decoding — a plain int read
// concurrently with the write is a C++ data race. Do not toggle while
// decodes are in flight if the windowed/full choice must stay consistent
// within a batch.
std::atomic<int> g_partial_decode{1};

// Refuse absurd decode/resize allocations instead of letting std::bad_alloc
// (or a 10+ GB buffer for a 65535x1 degenerate JPEG) take the process down.
constexpr size_t kMaxBufferBytes = size_t{1} << 30;  // 1 GiB per buffer

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Catmull-Rom bicubic kernel, a = -0.5 (PIL BICUBIC's kernel).
inline float cubic(float x) {
  constexpr float a = -0.5f;
  x = std::fabs(x);
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

// Separable bicubic resize with PIL-style antialiasing: on downscale the
// kernel is stretched by the scale factor (support 2*scale), matching
// Pillow's ImagingResample weight computation. Resamples from a float source
// box (x0, y0, w, h) so cropping is free. The filter taps CLAMP AT THE BOX
// EDGES — crop-then-resize semantics, like torchvision's RandomResizedCrop
// (PIL's resize(box=) would instead read neighboring full-image pixels,
// shifting window-border outputs; pinned by the executed-reference golden).
//
// ``src`` may be a partial-decode WINDOW of the full image: (src_x0, src_y0)
// is the window origin and (full_w, full_h) the full image dims. Tap centers,
// weights, and clamping are all computed in FULL-image coordinates (only the
// pixel indexing subtracts the origin), so the output is bit-identical
// whether the decode was windowed or full — window-relative float arithmetic
// would differ in ulps and flip rounded uint8s by ±1.
void resize_bicubic_box(const uint8_t* src, int sh, int sw, int src_x0,
                        int src_y0, int full_w, int full_h, float box_x,
                        float box_y, float box_w, float box_h, uint8_t* dst,
                        int dh, int dw) {
  const float scale_y = box_h / dh;
  const float scale_x = box_w / dw;

  struct Taps {
    std::vector<int> bounds;    // xmin per output pixel
    std::vector<int> counts;    // tap count per output pixel
    std::vector<float> weights; // concatenated normalized weights
    int max_taps;
  };

  // lo/hi clamp the tap range to the crop box (crop-then-resize semantics);
  // weights are normalized over the clamped range exactly like PIL does for
  // a resize of the cropped image.
  auto build_taps = [](int out_size, float scale, float offset, int lo,
                       int hi) {
    Taps t;
    const float filterscale = std::max(scale, 1.0f);
    const float support = 2.0f * filterscale;
    t.max_taps = static_cast<int>(std::ceil(support)) * 2 + 1;
    t.bounds.resize(out_size);
    t.counts.resize(out_size);
    t.weights.resize(static_cast<size_t>(out_size) * t.max_taps, 0.0f);
    for (int o = 0; o < out_size; ++o) {
      const float center = offset + (o + 0.5f) * scale;
      int xmin = static_cast<int>(center - support + 0.5f);
      int xmax = static_cast<int>(center + support + 0.5f);
      xmin = std::max(xmin, lo);
      xmax = std::min(xmax, hi);
      float wsum = 0.0f;
      float* w = &t.weights[static_cast<size_t>(o) * t.max_taps];
      for (int x = xmin; x < xmax; ++x) {
        const float wk = cubic((x - center + 0.5f) / filterscale);
        w[x - xmin] = wk;
        wsum += wk;
      }
      if (wsum != 0.0f)
        for (int k = 0; k < xmax - xmin; ++k) w[k] /= wsum;
      t.bounds[o] = xmin;
      t.counts[o] = xmax - xmin;
    }
    return t;
  };

  // box edges in (possibly DCT-scaled) source pixels; integral for an
  // unscaled RandomResizedCrop window, where the clamp is exactly
  // torchvision's crop edge
  const int box_x_lo = std::max(0, static_cast<int>(std::floor(box_x)));
  const int box_x_hi =
      std::min(full_w, static_cast<int>(std::ceil(box_x + box_w)));
  const int box_y_lo = std::max(0, static_cast<int>(std::floor(box_y)));
  const int box_y_hi =
      std::min(full_h, static_cast<int>(std::ceil(box_y + box_h)));
  const Taps tx = build_taps(dw, scale_x, box_x, box_x_lo, box_x_hi);
  const Taps ty = build_taps(dh, scale_y, box_y, box_y_lo, box_y_hi);

  // the vertical pass only reads rows inside the crop box's filter support
  // — restrict the horizontal pass to that range (a small RandomResizedCrop
  // of a large photo would otherwise resample every source row, like 10x
  // the needed work; PIL's ImagingResample restricts both passes too).
  // Full-image coordinates; additionally clamped to the decoded window.
  int row_lo = full_h, row_hi = 0;
  for (int oy = 0; oy < dh; ++oy) {
    row_lo = std::min(row_lo, ty.bounds[oy]);
    row_hi = std::max(row_hi, ty.bounds[oy] + ty.counts[oy]);
  }
  row_lo = std::max(row_lo, src_y0);
  row_hi = std::min(row_hi, src_y0 + sh);
  const int nrows = std::max(row_hi - row_lo, 0);

  // horizontal pass into float intermediate [nrows, dw, 3]
  std::vector<float> tmp(static_cast<size_t>(nrows) * dw * 3);
  for (int y = row_lo; y < row_hi; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y - src_y0) * sw * 3;
    for (int ox = 0; ox < dw; ++ox) {
      const float* w = &tx.weights[static_cast<size_t>(ox) * tx.max_taps];
      // tap bounds are full-image; clamp into the window (no-op when the
      // decode margin held, which the parity test pins)
      const int x0 = std::clamp(tx.bounds[ox] - src_x0, 0,
                                std::max(sw - tx.counts[ox], 0));
      float acc[3] = {0.0f, 0.0f, 0.0f};
      for (int k = 0; k < tx.counts[ox]; ++k) {
        const uint8_t* px = row + (x0 + k) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      float* out = &tmp[(static_cast<size_t>(y - row_lo) * dw + ox) * 3];
      out[0] = acc[0];
      out[1] = acc[1];
      out[2] = acc[2];
    }
  }
  // vertical pass
  for (int oy = 0; oy < dh; ++oy) {
    const float* w = &ty.weights[static_cast<size_t>(oy) * ty.max_taps];
    const int y0 = std::clamp(ty.bounds[oy], row_lo,
                              std::max(row_hi - ty.counts[oy], row_lo)) -
                   row_lo;
    for (int ox = 0; ox < dw; ++ox) {
      float acc[3] = {0.0f, 0.0f, 0.0f};
      for (int k = 0; k < ty.counts[oy]; ++k) {
        const float* px = &tmp[(static_cast<size_t>(y0 + k) * dw + ox) * 3];
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      uint8_t* out = dst + (static_cast<size_t>(oy) * dw + ox) * 3;
      for (int c = 0; c < 3; ++c)
        out[c] = static_cast<uint8_t>(
            std::clamp(acc[c] + 0.5f, 0.0f, 255.0f));
    }
  }
}

void resize_bicubic(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                    int dw) {
  resize_bicubic_box(src, sh, sw, 0, 0, sw, sh, 0.0f, 0.0f,
                     static_cast<float>(sw), static_cast<float>(sh), dst, dh,
                     dw);
}

// Shared decode: JPEG bytes → RGB pixel buffer, optionally DCT-scaled so the
// given region stays >= 2*target on its short side. On success fills
// `pixels` ([sh, sw, 3]) and the scale factors applied (output/original).
//
// ``box`` (x, y, w, h in ORIGINAL image coordinates, or nullptr) restricts
// the decode to the scanline/column window that resampling the box actually
// reads (libjpeg-turbo partial decompression; baseline JPEGs only). The
// retained pixels are bit-identical to a full decode except within a couple
// of pixels of the crop boundary, so the window carries the resampler's
// filter support plus an iMCU of slack — the resampler never reads the
// boundary-adjacent region. ``col_off``/``row_off`` report the decoded
// sub-image's origin in (DCT-scaled) output coordinates.
// Implementation frame: contains the setjmp and NO C++ objects of its own.
// The vectors live in the CALLER's frame and arrive as pointers (unmodified
// after setjmp), so a longjmp out of jpeg_read_scanlines can neither skip a
// destructor nor leave an automatic C++ object's value indeterminate
// (C11 7.13.2.1 — a non-volatile local modified after setjmp is
// indeterminate after longjmp; their heap effects are committed memory
// writes and stay valid). `cinfo` itself follows libjpeg's canonical
// example.c error idiom: its address escapes to the library, and the error
// branch only hands it back to jpeg_destroy_decompress.
int decode_pixels_impl(const uint8_t* data, long size, float region_short,
                       int target, std::vector<uint8_t>* pixels,
                       std::vector<uint8_t>* rowbuf, int* out_sw, int* out_sh,
                       float* fx, float* fy, const float* box, int* col_off,
                       int* row_off, int* full_w_out, int* full_h_out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  const unsigned orig_w = cinfo.image_width;
  const unsigned orig_h = cinfo.image_height;
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  // region_short <= 0 is a sentinel for "short side of the full image"
  // (saves decode_resize_crop a second full header parse just for dims)
  const float rshort =
      region_short > 0.0f
          ? region_short
          : static_cast<float>(std::min(orig_w, orig_h));
  for (int denom = 8; denom >= 2; denom /= 2) {
    if (rshort / denom >= 2.0f * target) {
      cinfo.scale_denom = denom;
      break;
    }
  }
  jpeg_start_decompress(&cinfo);

  // scale factors are the FULL scaled-image dims over the originals; a
  // partial-decode window below changes cinfo.output_width, so snapshot now
  const int full_sw = static_cast<int>(cinfo.output_width);
  const int full_sh = static_cast<int>(cinfo.output_height);
  const int channels = cinfo.output_components;
  if (channels != 3 && channels != 1) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }

  int xoff_applied = 0;
  int rows_skipped = 0;
  int rows_keep_hi = full_sh;
  if (g_partial_decode.load(std::memory_order_relaxed) && box != nullptr &&
      !cinfo.progressive_mode && full_sh > 0 && full_sw > 0) {
    const float fxs = static_cast<float>(full_sw) / orig_w;
    const float fys = static_cast<float>(full_sh) / orig_h;
    const float bx = box[0] * fxs;
    const float by = box[1] * fys;
    const float bw = box[2] * fxs;
    const float bh = box[3] * fys;
    // the resampler taps clamp at the box edge (crop-then-resize), so the
    // decode window needs no filter-support margin — only an iMCU (16 px)
    // of slack, because pixels within a couple px of a windowed-decode
    // boundary can differ from a full decode (chroma-upsampling edges)
    const int margin = 18;
    crop_scanline_fn crop_fn = get_crop_fn();
    if (crop_fn != nullptr) {
      const int x_lo = std::max(0, static_cast<int>(std::floor(bx)) - margin);
      const int x_hi = std::min(
          full_sw, static_cast<int>(std::ceil(bx + bw)) + margin);
      if (x_hi > x_lo && x_hi - x_lo < full_sw) {
        JDIMENSION xoff = static_cast<JDIMENSION>(x_lo);
        JDIMENSION xw = static_cast<JDIMENSION>(x_hi - x_lo);
        crop_fn(&cinfo, &xoff, &xw);  // expands to iMCU boundaries
        xoff_applied = static_cast<int>(xoff);
      }
    }
    skip_scanlines_fn skip_fn = get_skip_fn();
    if (skip_fn != nullptr) {
      const int y_lo = std::max(0, static_cast<int>(std::floor(by)) - margin);
      const int y_hi = std::min(
          full_sh, static_cast<int>(std::ceil(by + bh)) + margin);
      if (y_hi > y_lo) {
        if (y_lo > 0)
          rows_skipped = static_cast<int>(
              skip_fn(&cinfo, static_cast<JDIMENSION>(y_lo)));
        rows_keep_hi = y_hi;
      }
    }
  }

  const int sw = static_cast<int>(cinfo.output_width);  // post-crop width
  const int rows_kept = rows_keep_hi - rows_skipped;
  if (rows_kept <= 0) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 4;
  }
  if (static_cast<size_t>(sw) * rows_kept * 3 > kMaxBufferBytes) {
    // degenerate aspect ratios (e.g. 65535x1) explode the decode buffer;
    // refuse and let the caller fall back to PIL rather than bad_alloc
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 5;
  }
  pixels->resize(static_cast<size_t>(sw) * rows_kept * 3);
  rowbuf->resize(static_cast<size_t>(sw) * channels);
  while (static_cast<int>(cinfo.output_scanline) < rows_keep_hi) {
    uint8_t* rowptr = rowbuf->data();
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
    uint8_t* dst_row = &(*pixels)[static_cast<size_t>(
                           cinfo.output_scanline - 1 - rows_skipped) * sw * 3];
    if (channels == 3) {
      std::memcpy(dst_row, rowbuf->data(), static_cast<size_t>(sw) * 3);
    } else {  // grayscale → RGB
      for (int x = 0; x < sw; ++x) {
        dst_row[x * 3] = dst_row[x * 3 + 1] = dst_row[x * 3 + 2] =
            (*rowbuf)[x];
      }
    }
  }
  if (static_cast<int>(cinfo.output_scanline) <
      static_cast<int>(cinfo.output_height)) {
    jpeg_abort_decompress(&cinfo);  // bottom rows intentionally unread
  } else {
    jpeg_finish_decompress(&cinfo);
  }
  jpeg_destroy_decompress(&cinfo);
  *out_sw = sw;
  *out_sh = rows_kept;
  *fx = static_cast<float>(full_sw) / orig_w;
  *fy = static_cast<float>(full_sh) / orig_h;
  if (col_off != nullptr) *col_off = xoff_applied;
  if (row_off != nullptr) *row_off = rows_skipped;
  if (full_w_out != nullptr) *full_w_out = full_sw;
  if (full_h_out != nullptr) *full_h_out = full_sh;
  return 0;
}

int decode_pixels(const uint8_t* data, long size, float region_short,
                  int target, std::vector<uint8_t>* pixels, int* out_sw,
                  int* out_sh, float* fx, float* fy,
                  const float* box = nullptr, int* col_off = nullptr,
                  int* row_off = nullptr, int* full_w_out = nullptr,
                  int* full_h_out = nullptr) {
  // owns the scanline buffer so the setjmp frame (the impl) holds no C++
  // objects of its own
  std::vector<uint8_t> rowbuf;
  return decode_pixels_impl(data, size, region_short, target, pixels,
                            &rowbuf, out_sw, out_sh, fx, fy, box, col_off,
                            row_off, full_w_out, full_h_out);
}

}  // namespace

extern "C" {

// Toggle partial (windowed) decompression for the train path. On by
// default; tests turn it off to prove bit-parity against the full decode.
void set_partial_decode(int enabled) { g_partial_decode = enabled; }

// 1 when the libjpeg-turbo partial-decompression entry points resolved at
// runtime (jpeg_crop_scanline + jpeg_skip_scanlines), 0 when the build is
// degrading to full decodes. Lets tests assert the windowed path actually
// engages instead of passing vacuously on parity alone.
int partial_decode_supported(void) {
  return (get_crop_fn() != nullptr && get_skip_fn() != nullptr) ? 1 : 0;
}

// Read only the JPEG header; writes original width/height. 0 on success.
int jpeg_dims(const uint8_t* data, long size, int* width, int* height) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  *width = static_cast<int>(cinfo.image_width);
  *height = static_cast<int>(cinfo.image_height);
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Train-path: decode → crop the (x, y, w, h) box (original-image float
// coordinates, the torchvision RandomResizedCrop window — sampled by the
// CALLER so augmentation RNG stays in Python, per-item seeded) → bicubic
// resize to target×target → optional horizontal flip.
// DCT-domain scaling is applied when the crop is comfortably larger than the
// target; box coordinates are rescaled to match.
int decode_rrc(const uint8_t* data, long size, float x, float y, float w,
               float h, int target, int flip, uint8_t* out) try {
  std::vector<uint8_t> pixels;
  int sw, sh;
  float fx, fy;
  int col_off = 0, row_off = 0, full_w = 0, full_h = 0;
  const float region_short = std::min(w, h);
  const float box[4] = {x, y, w, h};
  const int rc = decode_pixels(data, size, region_short, target, &pixels,
                               &sw, &sh, &fx, &fy, box, &col_off, &row_off,
                               &full_w, &full_h);
  if (rc != 0) return rc;
  resize_bicubic_box(pixels.data(), sh, sw, col_off, row_off, full_w, full_h,
                     x * fx, y * fy, w * fx, h * fy, out, target, target);
  if (flip) {
    for (int row = 0; row < target; ++row) {
      uint8_t* r = out + static_cast<size_t>(row) * target * 3;
      for (int a = 0, b = target - 1; a < b; ++a, --b) {
        for (int c = 0; c < 3; ++c) std::swap(r[a * 3 + c], r[b * 3 + c]);
      }
    }
  }
  return 0;
} catch (...) {
  // an exception must never cross the ctypes FFI boundary (std::terminate
  // would take the training process down); nonzero = caller falls back
  return 9;
}

// Decode a JPEG byte buffer, resize shortest side to `target`, center-crop to
// target×target; writes target*target*3 uint8 RGB into `out`.
// Returns 0 on success, nonzero on failure (caller falls back to PIL).
int decode_resize_crop(const uint8_t* data, long size, int target,
                       uint8_t* out) try {
  std::vector<uint8_t> pixels_vec;
  int sw, sh;
  float fx, fy;
  {
    // region_short sentinel <= 0: decode_pixels uses the full image's short
    // side for the DCT-scale decision (no second header parse for dims)
    const int rc = decode_pixels(
        data, size, /*region_short=*/0.0f, target,
        &pixels_vec, &sw, &sh, &fx, &fy);
    if (rc != 0) return rc;
  }
  std::vector<uint8_t>& pixels = pixels_vec;

  // shortest-side resize. Rounding parity with the PIL path
  // (transforms.py resize_shortest), which mirrors torchvision's executed
  // _compute_resized_output_size: the long side TRUNCATES
  // (int(target * long / short)). The center crop below still rounds
  // half-to-even (Python 3 round()), matching torchvision's
  // int(round((h - th) / 2.0)).
  const auto round_half_even = [](double v) -> int {
    const double fl = std::floor(v);
    const double diff = v - fl;
    if (diff > 0.5) return static_cast<int>(fl) + 1;
    if (diff < 0.5) return static_cast<int>(fl);
    const int lo = static_cast<int>(fl);
    return (lo % 2 == 0) ? lo : lo + 1;
  };
  int rw, rh;
  if (sw <= sh) {
    rw = target;
    rh = static_cast<int>(static_cast<double>(target) * sh / sw);
  } else {
    rh = target;
    rw = static_cast<int>(static_cast<double>(target) * sw / sh);
  }
  if (rw <= 0 || rh <= 0 ||
      static_cast<size_t>(rw) * rh * 3 > kMaxBufferBytes) {
    return 6;  // degenerate aspect ratio (e.g. 65535x1) — PIL fallback
  }
  std::vector<uint8_t> resized(static_cast<size_t>(rw) * rh * 3);
  resize_bicubic(pixels.data(), sh, sw, resized.data(), rh, rw);

  // center crop target×target (Python-3 round-half-to-even like the PIL
  // path's int(round((w - tw) / 2.0)))
  const int x0 = round_half_even((rw - target) / 2.0);
  const int y0 = round_half_even((rh - target) / 2.0);
  for (int y = 0; y < target; ++y) {
    std::memcpy(out + static_cast<size_t>(y) * target * 3,
                &resized[(static_cast<size_t>(y0 + y) * rw + x0) * 3],
                static_cast<size_t>(target) * 3);
  }
  return 0;
} catch (...) {
  // an exception must never cross the ctypes FFI boundary (std::terminate
  // would take the training process down); nonzero = caller falls back
  return 9;
}

}  // extern "C"
