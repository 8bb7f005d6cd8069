// K10 · device-side image preprocessing: the PIL-style bilinear resize into
// a static canvas (K10a) and the fused normalise + per-image flip (K10b).
//
// Replaces: coin_tpu/ops/preprocess.py `resize_bilinear` (:44, weights
// `_resize_matrix` :28) and `normalize_flip` (:67).
//
// K10a. JAX builds two dense interpolation matrices, (H1, H0) and (W1, W0),
// and contracts the image with them, rows first ("yh,hwc->ywc"), then
// columns ("ywc,xw->yxc"): 16.7 GFLOP at 1024 x 2048 -> 608 x 1216 for a
// tent that has at most ceil(2 * support) + 1 non-zero taps per row. Here
// three launches do the same sum over the non-zero taps only:
//   1. `resize_weights`: one thread per output row and per output column
//      computes `_resize_matrix`'s row for it in f32, in JAX's operations
//      (pos = (i + 0.5) / scale - 0.5 clamped to [0, src - 1] before the
//      tent, support = max(1, 1 / scale), tent = max(0, 1 - |pos - j| /
//      support), divided by max(sum, 1e-8)), over a window of T taps that
//      holds every non-zero one: the first tap index and T weights.
//   2. `resize_rows`: tmp (ny, W0, 3) f32, each element the weighted sum of
//      its column's taps, one thread per element of a row (consecutive
//      threads read consecutive bytes of a source row).
//   3. `resize_cols`: out (H1, W1, 3), each element the weighted sum of its
//      row's taps in tmp; zeros at and past the scaled extent ny = round(H0
//      * scale), nx = round(W0 * scale) (f32 product, half to even; the
//      host computes both).
// Bound: bytes. The image is read once (6.29 MB of u8 at the path shape)
// and the canvas written once (8.87 MB of f32): 4.5 us at 3.35 TB/s. The
// f32 scratch (15 MB written and read) and the taps' re-reads of a source
// row (served by L2) are what this simple design adds to that. The sums run
// in ascending tap order with correctly rounded operations (no FMA
// contraction); XLA sums the dense rows in its own order, so the two agree
// to a few ulp, not bit for bit.
//
// K10b. One pass u8 -> f32, one thread per element of an output row:
// ((v / 255) - mean[c]) / std[c] with correctly rounded IEEE operations in
// the JAX source's order, reading column W - 1 - x of the same row where
// the image's flag is set. Bound: bytes (3 x 608 x 1216 x 3: 6.65 MB read,
// 26.6 MB written, 9.9 us). Bit for bit against the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
resize_weights(int h0, int h1, int w0, int w1, float scale, int taps,
               int* __restrict__ start, float* __restrict__ weight) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h1 + w1) return;
  const bool row = i < h1;
  const int dst = row ? i : i - h1;
  const int src = row ? h0 : w0;
  float pos = __fsub_rn(__fdiv_rn(__fadd_rn((float)dst, 0.5f), scale), 0.5f);
  pos = fminf(fmaxf(pos, 0.0f), (float)(src - 1));
  const float support = fmaxf(1.0f, __fdiv_rn(1.0f, scale));
  const int lo = max(0, (int)floorf(__fsub_rn(pos, support)));
  float sum = 0.0f;
  for (int t = 0; t < taps; ++t) {
    const int j = lo + t;
    if (j >= src) break;
    const float d = fabsf(__fsub_rn(pos, (float)j));
    sum = __fadd_rn(sum, fmaxf(0.0f, __fsub_rn(1.0f, __fdiv_rn(d, support))));
  }
  const float norm = fmaxf(sum, 1e-8f);
  start[i] = lo;
  for (int t = 0; t < taps; ++t) {
    const int j = lo + t;
    float w = 0.0f;
    if (j < src) {
      const float d = fabsf(__fsub_rn(pos, (float)j));
      w = __fdiv_rn(fmaxf(0.0f, __fsub_rn(1.0f, __fdiv_rn(d, support))), norm);
    }
    weight[(long long)i * taps + t] = w;
  }
}

// The row kernels index by (row, element of the row): the row comes from
// blockIdx.y (strided past 65535 rows), the element from blockIdx.x; the
// element's indices fit in 32 bits, so no thread divides a 64-bit index.
template <typename T>
__global__ void __launch_bounds__(kThreads)
resize_rows(const T* __restrict__ img, int h0, int w0, int ny, int taps,
            const int* __restrict__ start, const float* __restrict__ weight,
            float* __restrict__ tmp) {
  const int row_len = w0 * 3;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= row_len) return;
  for (int y = blockIdx.y; y < ny; y += gridDim.y) {
    const int lo = start[y];
    const float* w = weight + (long long)y * taps;
    float acc = 0.0f;
    for (int t = 0; t < taps; ++t) {
      const int j = lo + t;
      if (j >= h0) break;
      acc = __fadd_rn(acc,
                      __fmul_rn(w[t], (float)img[(long long)j * row_len + k]));
    }
    tmp[(long long)y * row_len + k] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
resize_cols(const float* __restrict__ tmp, int w0, int h1, int w1, int ny,
            int nx, int taps, const int* __restrict__ start,
            const float* __restrict__ weight, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= w1 * 3) return;
  const int x = k / 3;
  const int c = k - x * 3;
  for (int y = blockIdx.y; y < h1; y += gridDim.y) {
    float acc = 0.0f;
    if (y < ny && x < nx) {
      const int lo = start[h1 + x];
      const float* w = weight + (long long)(h1 + x) * taps;
      const float* row = tmp + (long long)y * w0 * 3 + c;
      for (int t = 0; t < taps; ++t) {
        const int j = lo + t;
        if (j >= w0) break;
        acc = __fadd_rn(acc, __fmul_rn(row[j * 3], w[t]));
      }
    }
    out[(long long)y * w1 * 3 + k] = acc;
  }
}

struct Norm {
  float mean[3];
  float std[3];
};

__global__ void __launch_bounds__(kThreads)
normalize_flip_kernel(const uint8_t* __restrict__ in,
                      const uint8_t* __restrict__ flip,
                      float* __restrict__ out, int b, int h, int w, Norm p) {
  const int row_len = w * 3;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= row_len) return;
  const int x = k / 3;
  const int c = k - x * 3;
  const int mirrored = (w - 1 - x) * 3 + c;
  const float mean = p.mean[c], std = p.std[c];
  for (int row = blockIdx.y; row < b * h; row += gridDim.y) {
    const long long base = (long long)row * row_len;
    const int src = flip[row / h] ? mirrored : k;
    const float v = (float)in[base + src];
    out[base + k] = __fdiv_rn(__fsub_rn(__fdiv_rn(v, 255.0f), mean), std);
  }
}

dim3 row_grid(int row_len, int rows) {
  return dim3((unsigned)((row_len + kThreads - 1) / kThreads),
              (unsigned)(rows < 65535 ? (rows > 0 ? rows : 1) : 65535));
}

}  // namespace

// image: (h0, w0, 3) u8 (is_u8 = 1) or f32; out: (h1, w1, 3) f32; tmp:
// (ny, w0, 3) f32 scratch (ny >= 1); start: h1 + w1 ints; weight: (h1 +
// w1) * taps floats. ny = min(round(h0 * scale), h1), nx likewise. Returns
// the CUDA error code of the launches (0 on success).
extern "C" int coin_resize_bilinear(const void* image, int is_u8, int h0,
                                    int w0, int h1, int w1, float scale,
                                    int ny, int nx, int taps, void* start,
                                    void* weight, void* tmp, void* out,
                                    void* stream) {
  if (h0 <= 0 || w0 <= 0 || h1 <= 0 || w1 <= 0 || taps <= 0 || ny < 0 ||
      nx < 0 || ny > h1 || nx > w1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  resize_weights<<<(h1 + w1 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      h0, h1, w0, w1, scale, taps, (int*)start, (float*)weight);
  if (ny > 0) {
    const dim3 grid = row_grid(w0 * 3, ny);
    if (is_u8)
      resize_rows<uint8_t><<<grid, kThreads, 0, s>>>(
          (const uint8_t*)image, h0, w0, ny, taps, (const int*)start,
          (const float*)weight, (float*)tmp);
    else
      resize_rows<float><<<grid, kThreads, 0, s>>>(
          (const float*)image, h0, w0, ny, taps, (const int*)start,
          (const float*)weight, (float*)tmp);
  }
  resize_cols<<<row_grid(w1 * 3, h1), kThreads, 0, s>>>(
      (const float*)tmp, w0, h1, w1, ny, nx, taps, (const int*)start,
      (const float*)weight, (float*)out);
  return (int)cudaGetLastError();
}

// in: (b, h, w, 3) u8; flip: b bytes (0 or 1); out: (b, h, w, 3) f32.
extern "C" int coin_normalize_flip(const void* in, const void* flip,
                                   void* out, int b, int h, int w,
                                   const float* mean, const float* std,
                                   void* stream) {
  if (b <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  Norm p;
  for (int c = 0; c < 3; ++c) {
    p.mean[c] = mean[c];
    p.std[c] = std[c];
  }
  normalize_flip_kernel<<<row_grid(w * 3, b * h), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)in, (const uint8_t*)flip, (float*)out, b, h, w, p);
  return (int)cudaGetLastError();
}
