// The port's native data-loader core: threaded JPEG decode + bilinear
// resize into a packed uint8 canvas batch (the port's own copy of the
// JAX package's coin_tpu/native/decoder.cpp, with the same arithmetic,
// so that both libraries give the same bytes).
//
// Exposed through ctypes (coin_tpu_torch/native/__init__.py); the loader
// (coin_tpu_torch/data/loader.py) falls back to PIL when it isn't built.
//
// Fast path: libjpeg DCT-domain prescaling (scale_num/8) down to the
// nearest size >= target, then exact separable bilinear to the target.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// 1-D PIL-BILINEAR weights: triangle filter widened by the downscale
// factor (antialias), row-normalized
void filter_weights(int src, int dst, std::vector<int>& starts,
                    std::vector<int>& sizes, std::vector<float>& weights) {
  const float scale = static_cast<float>(src) / dst;
  const float support = std::max(1.0f, scale);
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  starts.resize(dst);
  sizes.resize(dst);
  weights.assign(static_cast<size_t>(dst) * ksize, 0.0f);
  for (int x = 0; x < dst; ++x) {
    float center = (x + 0.5f) * scale - 0.5f;
    int lo = std::max(0, static_cast<int>(std::floor(center - support)));
    int hi = std::min(src - 1,
                      static_cast<int>(std::ceil(center + support)));
    float total = 0.0f;
    int n = 0;
    for (int s = lo; s <= hi && n < ksize; ++s, ++n) {
      float w = 1.0f - std::abs(s - center) / support;
      w = std::max(0.0f, w);
      weights[static_cast<size_t>(x) * ksize + n] = w;
      total += w;
    }
    starts[x] = lo;
    sizes[x] = n;
    if (total > 0.0f) {
      for (int k = 0; k < n; ++k) {
        weights[static_cast<size_t>(x) * ksize + k] /= total;
      }
    }
  }
}

// separable PIL-style antialiased bilinear resize, RGB u8
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  std::vector<int> xs_start, xs_size, ys_start, ys_size;
  std::vector<float> xw, yw;
  filter_weights(sw, dw, xs_start, xs_size, xw);
  filter_weights(sh, dh, ys_start, ys_size, yw);
  const int xk = xw.size() / dw;
  const int yk = yw.size() / dh;

  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
    float* out = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float acc[3] = {0, 0, 0};
      const float* w = xw.data() + static_cast<size_t>(x) * xk;
      for (int k = 0; k < xs_size[x]; ++k) {
        const uint8_t* px = row + (xs_start[x] + k) * 3;
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      out[x * 3] = acc[0];
      out[x * 3 + 1] = acc[1];
      out[x * 3 + 2] = acc[2];
    }
  }
  for (int y = 0; y < dh; ++y) {
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    const float* w = yw.data() + static_cast<size_t>(y) * yk;
    for (int i = 0; i < dw * 3; ++i) {
      float v = 0.0f;
      for (int k = 0; k < ys_size[y]; ++k) {
        v += w[k] * tmp[static_cast<size_t>(ys_start[y] + k) * dw * 3
                        + i];
      }
      out[i] = static_cast<uint8_t>(
          std::min(std::max(v + 0.5f, 0.0f), 255.0f));
    }
  }
}

// decode one JPEG and resize into a (canvas_h, canvas_w) buffer (top-left
// placement, zero padding). Returns 0 on success.
int decode_one(const uint8_t* data, size_t len, float scale,
               uint8_t* canvas, int canvas_h, int canvas_w,
               int32_t* out_hw /* nh, nw, orig_h, orig_w */) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  const int orig_h = cinfo.image_height;
  const int orig_w = cinfo.image_width;
  int nh = static_cast<int>(std::lround(orig_h * scale));
  int nw = static_cast<int>(std::lround(orig_w * scale));
  nh = std::min(nh, canvas_h);
  nw = std::min(nw, canvas_w);

  // DCT-domain prescale: smallest n/8 >= target
  int num = 8;
  for (int n = 1; n <= 8; ++n) {
    if (orig_w * n / 8 >= nw && orig_h * n / 8 >= nh) {
      num = n;
      break;
    }
  }
  cinfo.scale_num = num;
  cinfo.scale_denom = 8;
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int sh = cinfo.output_height;
  const int sw = cinfo.output_width;
  std::vector<uint8_t> buf(static_cast<size_t>(sh) * sw * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf.data()
        + static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  std::vector<uint8_t> resized(static_cast<size_t>(nh) * nw * 3);
  resize_bilinear(buf.data(), sh, sw, resized.data(), nh, nw);
  for (int y = 0; y < nh; ++y) {
    std::memcpy(canvas + (static_cast<size_t>(y) * canvas_w) * 3,
                resized.data() + static_cast<size_t>(y) * nw * 3,
                static_cast<size_t>(nw) * 3);
  }
  out_hw[0] = nh;
  out_hw[1] = nw;
  out_hw[2] = orig_h;
  out_hw[3] = orig_w;
  return 0;
}

}  // namespace

extern "C" {

// Batch API: decode `n` JPEGs in parallel into a contiguous canvas
// buffer (n, canvas_h, canvas_w, 3). Returns the number of failures.
int coin_decode_batch(const uint8_t** datas, const size_t* lens,
                      const float* scales, int n, uint8_t* canvases,
                      int canvas_h, int canvas_w, int32_t* out_hw,
                      int num_threads) {
  std::vector<int> fails(n, 0);
  const size_t canvas_stride =
      static_cast<size_t>(canvas_h) * canvas_w * 3;
  std::memset(canvases, 0, canvas_stride * n);
  int workers = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  for (int t = 0; t < workers; ++t) {
    threads.emplace_back([&, t]() {
      for (int i = t; i < n; i += workers) {
        fails[i] = decode_one(datas[i], lens[i], scales[i],
                              canvases + canvas_stride * i, canvas_h,
                              canvas_w, out_hw + 4 * i);
      }
    });
  }
  for (auto& th : threads) th.join();
  int total = 0;
  for (int f : fails) total += f;
  return total;
}

// Probe JPEG dimensions without decoding (header only).
int coin_jpeg_size(const uint8_t* data, size_t len, int32_t* hw) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  hw[0] = cinfo.image_height;
  hw[1] = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
