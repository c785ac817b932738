// Native host image preprocessing: Pillow-exact separable resampling on uint8.
//
// Replaces the reference's Pillow/PIL resize hot loop (CLIPImageProcessor's
// resize path) for the serving front-ends.  Bit-identical to PIL
// Image.resize(BICUBIC/BILINEAR): double-precision kernels normalized then
// rounded to 1<<22 fixed point, two quantized 8bpc passes (horizontal first),
// accumulators seeded with the half-ulp, clip8 per pixel.  The executable
// spec is visualcla_tpu/processor/pil_resample.py.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC imgproc.cpp -o libimgproc.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // 22

double bicubic(double x) {
  const double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

double bilinear(double x) {
  x = std::fabs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

inline uint8_t clip8(int64_t acc) {
  acc >>= kPrecisionBits;
  if (acc < 0) return 0;
  if (acc > 255) return 255;
  return static_cast<uint8_t>(acc);
}

struct Coeffs {
  std::vector<int32_t> xmin;           // per output pixel
  std::vector<std::vector<int64_t>> kk;  // per output pixel kernel taps
};

Coeffs precompute(int in_size, int out_size, int filter) {
  double (*fn)(double) = filter == 0 ? bicubic : bilinear;
  double support0 = filter == 0 ? 2.0 : 1.0;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = support0 * filterscale;
  double ss = 1.0 / filterscale;

  Coeffs c;
  c.xmin.resize(out_size);
  c.kk.resize(out_size);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = std::max(0, static_cast<int>(std::floor(center - support)));
    int xmax = std::min(in_size, static_cast<int>(std::ceil(center + support)));
    std::vector<double> w(xmax - xmin);
    double wsum = 0.0;
    for (int x = 0; x < xmax - xmin; ++x) {
      w[x] = fn((x + xmin - center + 0.5) * ss);
      wsum += w[x];
    }
    if (wsum == 0.0) wsum = 1.0;
    c.xmin[xx] = xmin;
    c.kk[xx].resize(w.size());
    for (size_t x = 0; x < w.size(); ++x)
      c.kk[xx][x] = llround(w[x] / wsum * (1 << kPrecisionBits));
  }
  return c;
}

// resample along the horizontal (width) axis: (H, W, C) -> (H, W2, C)
void resample_w(const uint8_t* src, int h, int w, int ch, int w2, int filter,
                uint8_t* dst) {
  Coeffs c = precompute(w, w2, filter);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<int64_t>(y) * w * ch;
    uint8_t* orow = dst + static_cast<int64_t>(y) * w2 * ch;
    for (int xx = 0; xx < w2; ++xx) {
      const auto& kk = c.kk[xx];
      int xmin = c.xmin[xx];
      for (int cc = 0; cc < ch; ++cc) {
        int64_t acc = 1 << (kPrecisionBits - 1);
        const uint8_t* p = row + static_cast<int64_t>(xmin) * ch + cc;
        for (size_t t = 0; t < kk.size(); ++t) acc += kk[t] * p[t * ch];
        orow[static_cast<int64_t>(xx) * ch + cc] = clip8(acc);
      }
    }
  }
}

// resample along the vertical (height) axis: (H, W, C) -> (H2, W, C)
void resample_h(const uint8_t* src, int h, int w, int ch, int h2, int filter,
                uint8_t* dst) {
  Coeffs c = precompute(h, h2, filter);
  int64_t row_stride = static_cast<int64_t>(w) * ch;
  for (int yy = 0; yy < h2; ++yy) {
    const auto& kk = c.kk[yy];
    int ymin = c.xmin[yy];
    uint8_t* orow = dst + static_cast<int64_t>(yy) * row_stride;
    for (int64_t i = 0; i < row_stride; ++i) {
      int64_t acc = 1 << (kPrecisionBits - 1);
      const uint8_t* p = src + static_cast<int64_t>(ymin) * row_stride + i;
      for (size_t t = 0; t < kk.size(); ++t) acc += kk[t] * p[t * row_stride];
      orow[i] = clip8(acc);
    }
  }
}

}  // namespace

extern "C" {

// filter: 0 = bicubic, 1 = bilinear.  Returns 0 on success.
int imgproc_resize_u8(const uint8_t* src, int32_t h, int32_t w, int32_t ch,
                      int32_t h2, int32_t w2, int32_t filter, uint8_t* dst) {
  if (h <= 0 || w <= 0 || ch <= 0 || h2 <= 0 || w2 <= 0) return 1;
  if (h == h2 && w == w2) {
    std::memcpy(dst, src, static_cast<int64_t>(h) * w * ch);
    return 0;
  }
  std::vector<uint8_t> tmp;
  const uint8_t* cur = src;
  int cur_h = h, cur_w = w;
  std::vector<uint8_t> mid;
  if (w2 != w) {  // horizontal pass first, like ImagingResample
    mid.resize(static_cast<int64_t>(h) * w2 * ch);
    resample_w(cur, h, w, ch, w2, filter, mid.data());
    cur = mid.data();
    cur_w = w2;
  }
  if (h2 != h) {
    resample_h(cur, cur_h, cur_w, ch, h2, filter,
               dst);
  } else {
    std::memcpy(dst, cur, static_cast<int64_t>(cur_h) * cur_w * ch);
  }
  return 0;
}

// full CLIP preprocess: resize shortest edge -> center crop -> rescale ->
// normalize -> CHW float32.  mean/std are per-channel (ch floats each).
int imgproc_clip_preprocess(const uint8_t* src, int32_t h, int32_t w,
                            int32_t ch, int32_t shortest, int32_t crop,
                            int32_t filter, const float* mean,
                            const float* std_, float* dst_chw) {
  // shortest-edge sizing with int truncation (HF get_resize_output_image_size)
  int nh, nw;
  if (h <= w) {
    nh = shortest;
    nw = static_cast<int>(static_cast<int64_t>(shortest) * w / h);
  } else {
    nw = shortest;
    nh = static_cast<int>(static_cast<int64_t>(shortest) * h / w);
  }
  std::vector<uint8_t> resized(static_cast<int64_t>(nh) * nw * ch);
  if (imgproc_resize_u8(src, h, w, ch, nh, nw, filter, resized.data())) return 1;
  int top = (nh - crop) / 2, left = (nw - crop) / 2;
  for (int cc = 0; cc < ch; ++cc) {
    float inv = 1.0f / 255.0f / std_[cc];
    float bias = -mean[cc] / std_[cc];
    for (int y = 0; y < crop; ++y) {
      int sy = y + top;
      for (int x = 0; x < crop; ++x) {
        int sx = x + left;
        float v = 0.0f;
        if (sy >= 0 && sy < nh && sx >= 0 && sx < nw)
          v = resized[(static_cast<int64_t>(sy) * nw + sx) * ch + cc];
        dst_chw[(static_cast<int64_t>(cc) * crop + y) * crop + x] =
            v * inv + bias;
      }
    }
  }
  return 0;
}

}  // extern "C"
