// K4 · the strong and weak views of a u8 NHWC image batch, for Hopper.
//
// Replaces: coin_tpu/data/augment.py `preprocess_batch` (:105) with
// `strong_augment_single` (:91), `_color_jitter` (:29), `_band_matrix`
// (:52), `_gaussian_blur` (:64) and `_solarize` (:87). On the TPU the
// 9-tap blur is two dense banded-matrix contractions, because a depthwise
// conv at 3 channels starves the MXU; here it is two direct 9-tap passes.
// The random draws come in as per-image parameters, so the kernel and the
// plain version (coin_tpu_torch/data/augment.py) see the same values.
//
// Per image, in order: colour jitter (brightness b, contrast c around the
// mean gray of the whole canvas, saturation s around the pixel's gray, hue
// as a mix with the channel-rolled pixel, one clip to [0, 1]) if its gate
// is on; grayscale if on; a separable 9-tap Gaussian blur, zero-padded at
// the canvas edges, if on; solarize at 0.5 if on; then CLIP normalisation.
// The weak view is the plain CLIP normalisation (K4n's arithmetic).
//
// Bound: bytes. At the training shape (3, 608, 1216, 3) the function must
// read 6.6 MB of u8 and write 2 x 26.6 MB of f32: about 0.018 ms at
// 3.35 TB/s. Design, three launches: (1) a per-image reduction of the gray
// mean of img * b over the canvas (double atomics, one per block); (2) the
// vertical pass, with jitter and gray fused into its loads, into an f32
// scratch image (a pass-through copy for images whose blur gate is off);
// (3) the horizontal pass, solarize and normalisation, which also writes
// the weak view. One thread per pixel, all three channels. Arithmetic is
// correctly rounded intrinsics in the order of the plain version, so no
// FMA contraction separates the two.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kParams = 20;     // per image, see coin_augment's comment
constexpr int kRadius = 4;

struct Norm {
  float mean[3];
  float std[3];
};

__device__ __forceinline__ float to_unit(uint8_t v) {
  return __fdiv_rn((float)v, 255.0f);
}

__device__ __forceinline__ float gray3(float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r, 0.299f), __fmul_rn(g, 0.587f)),
                   __fmul_rn(b, 0.114f));
}

// the jittered and grayed value of one pixel (3 channels)
__device__ __forceinline__ void photometric(const uint8_t* px,
                                            const float* p, float mean,
                                            float* v) {
  v[0] = to_unit(px[0]);
  v[1] = to_unit(px[1]);
  v[2] = to_unit(px[2]);
  if (p[0] != 0.0f) {
    const float b = p[4], c = p[5], s = p[6], h = p[7];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = __fmul_rn(v[k], b);
      v[k] = __fadd_rn(__fmul_rn(__fsub_rn(v[k], mean), c), mean);
    }
    const float g = gray3(v[0], v[1], v[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = __fadd_rn(__fmul_rn(__fsub_rn(v[k], g), s), g);
    }
    // roll by one along the channels: the new R mixes with the old B
    const float r0 = v[0], g0 = v[1], b0 = v[2];
    v[0] = __fadd_rn(r0, __fmul_rn(h, __fsub_rn(b0, r0)));
    v[1] = __fadd_rn(g0, __fmul_rn(h, __fsub_rn(r0, g0)));
    v[2] = __fadd_rn(b0, __fmul_rn(h, __fsub_rn(g0, b0)));
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = fminf(fmaxf(v[k], 0.0f), 1.0f);
  }
  if (p[1] != 0.0f) {
    const float g = gray3(v[0], v[1], v[2]);
    v[0] = g; v[1] = g; v[2] = g;
  }
}

__global__ void __launch_bounds__(kThreads)
gray_mean_kernel(const uint8_t* __restrict__ img,
                 const float* __restrict__ params,
                 double* __restrict__ sums, int HW) {
  const int b = blockIdx.y;
  const float* p = params + b * kParams;
  if (p[0] == 0.0f) return;
  const uint8_t* base = img + (size_t)b * HW * 3;
  const float bright = p[4];
  double acc = 0.0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < HW;
       i += gridDim.x * blockDim.x) {
    const uint8_t* px = base + (size_t)i * 3;
    acc += (double)gray3(__fmul_rn(to_unit(px[0]), bright),
                         __fmul_rn(to_unit(px[1]), bright),
                         __fmul_rn(to_unit(px[2]), bright));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffff, acc, o);
  __shared__ double warp_sums[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += warp_sums[w];
    atomicAdd(sums + b, t);
  }
}

__device__ __forceinline__ float image_mean(const double* sums, int b,
                                            int HW) {
  return (float)(sums[b] / (double)HW);
}

__global__ void __launch_bounds__(kThreads)
vertical_kernel(const uint8_t* __restrict__ img,
                const float* __restrict__ params,
                const double* __restrict__ sums,
                float* __restrict__ scratch, int B, int H, int W) {
  const long long total = (long long)B * H * W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int x = (int)(i % W);
    const int y = (int)((i / W) % H);
    const int b = (int)(i / ((long long)H * W));
    const float* p = params + b * kParams;
    const float mean = p[0] != 0.0f ? image_mean(sums, b, H * W) : 0.0f;
    const uint8_t* col = img + ((size_t)b * H * W + x) * 3;
    float out[3];
    if (p[2] == 0.0f) {
      photometric(col + (size_t)y * W * 3, p, mean, out);
    } else {
      out[0] = 0.0f; out[1] = 0.0f; out[2] = 0.0f;
#pragma unroll
      for (int t = 0; t <= 2 * kRadius; ++t) {
        const int yy = y + t - kRadius;
        if (yy < 0 || yy >= H) continue;
        float v[3];
        photometric(col + (size_t)yy * W * 3, p, mean, v);
        const float k = p[8 + t];
#pragma unroll
        for (int c = 0; c < 3; ++c) out[c] = __fadd_rn(out[c], __fmul_rn(k, v[c]));
      }
    }
    float* o = scratch + (size_t)i * 3;
    o[0] = out[0]; o[1] = out[1]; o[2] = out[2];
  }
}

__global__ void __launch_bounds__(kThreads)
horizontal_kernel(const uint8_t* __restrict__ img,
                  const float* __restrict__ params,
                  const float* __restrict__ scratch,
                  float* __restrict__ strong, float* __restrict__ weak,
                  int B, int H, int W, Norm n) {
  const long long total = (long long)B * H * W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int x = (int)(i % W);
    const int b = (int)(i / ((long long)H * W));
    const float* p = params + b * kParams;
    float v[3];
    if (p[2] == 0.0f) {
      const float* s = scratch + (size_t)i * 3;
      v[0] = s[0]; v[1] = s[1]; v[2] = s[2];
    } else {
      v[0] = 0.0f; v[1] = 0.0f; v[2] = 0.0f;
#pragma unroll
      for (int t = 0; t <= 2 * kRadius; ++t) {
        const int xx = x + t - kRadius;
        if (xx < 0 || xx >= W) continue;
        const float* s = scratch + (size_t)(i + (xx - x)) * 3;
        const float k = p[8 + t];
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = __fadd_rn(v[c], __fmul_rn(k, s[c]));
      }
    }
    const uint8_t* px = img + (size_t)i * 3;
    float* so = strong + (size_t)i * 3;
    float* wo = weak + (size_t)i * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float u = v[c];
      if (p[3] != 0.0f && u >= 0.5f) u = __fsub_rn(1.0f, u);
      so[c] = __fdiv_rn(__fsub_rn(u, n.mean[c]), n.std[c]);
      wo[c] = __fdiv_rn(__fsub_rn(to_unit(px[c]), n.mean[c]), n.std[c]);
    }
  }
}

unsigned grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 64) blocks = 132 * 64;
  return (unsigned)blocks;
}

}  // namespace

// img: (B, H, W, 3) u8; params: (B, 20) f32 per image = gates (jitter,
// gray, blur, solarize; 1 = on), brightness, contrast, saturation, hue,
// the 9 normalised blur taps, 3 unused; sums: (B,) f64 zeroed; scratch:
// (B, H, W, 3) f32; strong, weak: (B, H, W, 3) f32. All on one device,
// 16-byte aligned. Returns the first CUDA error code of the three launches.
extern "C" int coin_augment(const void* img, const void* params, void* sums,
                            void* scratch, void* strong, void* weak, int B,
                            int H, int W, const float* mean,
                            const float* std, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Norm n;
  for (int c = 0; c < 3; ++c) {
    n.mean[c] = mean[c];
    n.std[c] = std[c];
  }
  const int HW = H * W;
  int per_image = (HW + kThreads * 16 - 1) / (kThreads * 16);
  if (per_image > 256) per_image = 256;
  gray_mean_kernel<<<dim3(per_image, B), kThreads, 0, s>>>(
      (const uint8_t*)img, (const float*)params, (double*)sums, HW);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long total = (long long)B * HW;
  vertical_kernel<<<grid_for(total), kThreads, 0, s>>>(
      (const uint8_t*)img, (const float*)params, (const double*)sums,
      (float*)scratch, B, H, W);
  err = (int)cudaGetLastError();
  if (err) return err;
  horizontal_kernel<<<grid_for(total), kThreads, 0, s>>>(
      (const uint8_t*)img, (const float*)params, (const float*)scratch,
      (float*)strong, (float*)weak, B, H, W, n);
  return (int)cudaGetLastError();
}
