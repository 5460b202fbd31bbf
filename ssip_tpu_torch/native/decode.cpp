// ssip_tpu native JPEG decoder + exact host preprocessing.
//
// Host-side decode is the end-to-end bottleneck of the extraction pipeline
// (SURVEY.md §6: single-core PIL full decode ≈ 175 imgs/s). This libjpeg
// wrapper removes the Python/PIL overhead, supports DCT-domain scaled decode
// (scale_denom ∈ {1,2,4,8} — decode 512² JPEGs straight to 256² for the
// throughput path), forces RGB output, and is called with the GIL released
// so Python-level thread pools overlap decode with device dispatch.
//
// ssip_resize_crop_u8 adds the EXACT host preprocessing step: Pillow's
// antialiased triangle-filter (bilinear) resample reimplemented in its own
// 8bpc fixed-point arithmetic — BITWISE identical to PIL.Image.resize on
// every shape — fused with the center crop by restricting both passes to
// the kept output window. This is what lets --host-preproc ship only
// crop²×3 bytes over the host→device link without paying a Python/PIL
// resize per image on the 1-core host (round-2 verdict item 3).
//
// C ABI only — consumed via ctypes (ssip_tpu/native/decoder.py).

#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

void silent_output(j_common_ptr) {}

// One axis of PIL's antialiased bilinear (triangle-filter) resample, in
// PIL's own 8bpc fixed-point representation: normalized double weights
// quantized to INT at PRECISION_BITS (Pillow Resample.c
// normalize_coeffs_8bpc), accumulated in integers and shifted back by
// clip8. This makes the native resample BITWISE identical to PIL on every
// shape — the same oracle the device chain is tested against.
constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's PRECISION_BITS

struct AxisWeights {
  std::vector<int> lo;
  std::vector<int> len;
  std::vector<int> taps;  // fixed-point, stride = ksize
  int ksize = 0;
};

AxisWeights triangle_weights(int src, int dst, int out0, int out_len) {
  const double scale = static_cast<double>(src) / dst;
  const double fscale = scale > 1.0 ? scale : 1.0;
  const double support = fscale;  // bilinear support 1.0 * filterscale
  AxisWeights aw;
  aw.ksize = static_cast<int>(2.0 * support + 1.0) + 1;
  aw.lo.resize(out_len);
  aw.len.resize(out_len);
  aw.taps.assign(static_cast<size_t>(out_len) * aw.ksize, 0);
  std::vector<double> k(aw.ksize);
  for (int oi = 0; oi < out_len; ++oi) {
    const int i = out0 + oi;
    const double center = (i + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    if (lo < 0) lo = 0;
    int hi = static_cast<int>(center + support + 0.5);
    if (hi > src) hi = src;
    double sum = 0.0;
    for (int j = lo; j < hi; ++j) {
      const double x = (j + 0.5 - center) / fscale;
      double w = 1.0 - (x < 0 ? -x : x);
      if (w < 0.0) w = 0.0;
      k[j - lo] = w;
      sum += w;
    }
    for (int t = 0; t < hi - lo; ++t) {
      const double v = (sum != 0.0 ? k[t] / sum : k[t]) *
                       (1 << kPrecisionBits);
      // Pillow rounds the quantized coefficient half away from zero.
      aw.taps[static_cast<size_t>(oi) * aw.ksize + t] =
          static_cast<int>(v < 0 ? v - 0.5 : v + 0.5);
    }
    aw.lo[oi] = lo;
    aw.len[oi] = hi - lo;
  }
  return aw;
}

// Pillow's clip8: shift out the precision bits, clamp to [0, 255].
inline unsigned char clip8(long long in) {
  if (in >= (1LL << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<unsigned char>(in >> kPrecisionBits);
}

}  // namespace

extern "C" {

// Reads header only; returns 0 on success and fills (w, h) with the
// dimensions that a decode at the given scale_denom will produce.
int ssip_jpeg_dims(const char* path, int scale_denom, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silent_output;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -2;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale_denom > 0 ? scale_denom : 1;
  jpeg_calc_output_dimensions(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

// Full decode into caller-provided buffer (capacity bytes). Output is always
// 3-channel RGB, row-major HWC. Returns 0 on success; fills (w, h).
int ssip_jpeg_decode(const char* path, int scale_denom, unsigned char* out,
                     long capacity, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silent_output;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -2;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale_denom > 0 ? scale_denom : 1;
  cinfo.out_color_space = JCS_RGB;  // grayscale JPEGs get replicated by libjpeg
  jpeg_start_decompress(&cinfo);

  const int width = static_cast<int>(cinfo.output_width);
  const int height = static_cast<int>(cinfo.output_height);
  const int comps = cinfo.output_components;  // 3 after JCS_RGB
  const long needed = static_cast<long>(width) * height * comps;
  if (comps != 3 || needed > capacity) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -3;
  }

  const long row_stride = static_cast<long>(width) * comps;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<long>(cinfo.output_scanline) * row_stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  *w = width;
  *h = height;
  return 0;
}

// Exact host preprocessing: antialiased triangle-filter resize of an RGB
// uint8 image from (h, w) to (th, tw), fused with a center crop — only the
// output window [row0, row0+crop) × [col0, col0+crop) is computed. PIL's
// pass order and per-pass uint8 quantization are preserved: horizontal
// resample first (clip8 between passes), then vertical. Accumulation is
// PIL's fixed-point integer scheme (weights quantized at kPrecisionBits,
// long-long accumulator seeded at the rounding bias, clip8 shift-back) —
// NOT floating point. That integer path is exactly what makes the output
// BITWISE identical to PIL (the contract tests/test_native_decoder.py
// enforces); do not "upgrade" it to double accumulation. Returns 0 on
// success.
int ssip_resize_crop_u8(const unsigned char* src, int h, int w, int th,
                        int tw, int row0, int col0, int crop,
                        unsigned char* out) {
  if (h <= 0 || w <= 0 || th <= 0 || tw <= 0 || crop <= 0) return -1;
  if (row0 < 0 || col0 < 0 || row0 + crop > th || col0 + crop > tw) return -1;

  // Identity fast path: pure center crop.
  if (h == th && w == tw) {
    for (int r = 0; r < crop; ++r) {
      std::memcpy(out + static_cast<size_t>(r) * crop * 3,
                  src + (static_cast<size_t>(row0 + r) * w + col0) * 3,
                  static_cast<size_t>(crop) * 3);
    }
    return 0;
  }

  const AxisWeights wh = triangle_weights(w, tw, col0, crop);
  const AxisWeights wv = triangle_weights(h, th, row0, crop);

  // Pass 1 (horizontal, PIL order): full source height × cropped cols,
  // integer accumulation seeded at the rounding bias, clip8 per pass —
  // exactly Pillow's ImagingResampleHorizontal_8bpc.
  const long long bias = 1LL << (kPrecisionBits - 1);
  std::vector<unsigned char> mid(static_cast<size_t>(h) * crop * 3);
  for (int y = 0; y < h; ++y) {
    const unsigned char* row = src + static_cast<size_t>(y) * w * 3;
    unsigned char* mrow = mid.data() + static_cast<size_t>(y) * crop * 3;
    for (int oc = 0; oc < crop; ++oc) {
      const int lo = wh.lo[oc];
      const int len = wh.len[oc];
      const int* taps = &wh.taps[static_cast<size_t>(oc) * wh.ksize];
      long long acc0 = bias, acc1 = bias, acc2 = bias;
      for (int t = 0; t < len; ++t) {
        const unsigned char* px = row + static_cast<size_t>(lo + t) * 3;
        acc0 += static_cast<long long>(taps[t]) * px[0];
        acc1 += static_cast<long long>(taps[t]) * px[1];
        acc2 += static_cast<long long>(taps[t]) * px[2];
      }
      mrow[oc * 3 + 0] = clip8(acc0);
      mrow[oc * 3 + 1] = clip8(acc1);
      mrow[oc * 3 + 2] = clip8(acc2);
    }
  }

  // Pass 2 (vertical) over the cropped rows.
  for (int orow = 0; orow < crop; ++orow) {
    const int lo = wv.lo[orow];
    const int len = wv.len[orow];
    const int* taps = &wv.taps[static_cast<size_t>(orow) * wv.ksize];
    unsigned char* dst = out + static_cast<size_t>(orow) * crop * 3;
    for (int oc = 0; oc < crop * 3; ++oc) {
      long long acc = bias;
      for (int t = 0; t < len; ++t) {
        acc += static_cast<long long>(taps[t]) *
               mid[static_cast<size_t>(lo + t) * crop * 3 + oc];
      }
      dst[oc] = clip8(acc);
    }
  }
  return 0;
}

}  // extern "C"
