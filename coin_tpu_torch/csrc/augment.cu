// K4 · the strong and weak views of a u8 NHWC image batch, for Hopper.
//
// Replaces: coin_tpu/data/augment.py `preprocess_batch` (:106) with
// `strong_augment_single` (:91), `_color_jitter` (:29), `_grayscale` (:47),
// `_band_matrix` (:52) / `_gaussian_blur` (:64) and `_solarize` (:87). On
// the TPU the 9-tap blur is two dense banded-matrix contractions, because a
// depthwise conv at 3 channels starves the MXU; here it is two direct 9-tap
// passes in shared memory. The random draws come in as per-image
// parameters, so the kernel and the plain version
// (coin_tpu_torch/data/augment.py) see the same values.
//
// Per image, in order: colour jitter (brightness b, contrast c around the
// mean gray of the whole canvas, saturation s around the pixel's gray, hue
// as a mix with the channel-rolled pixel, one clip to [0, 1]) if its gate
// is on; grayscale if on; a separable 9-tap Gaussian blur, zero-padded at
// the canvas edges, if on; solarize at 0.5 if on; then CLIP normalisation.
// The weak view is the plain CLIP normalisation (K4n's arithmetic), written
// only when the caller asks for it.
//
// Bound: bytes. At the training shape (3, 608, 1216, 3) the function must
// read 6.6 MB of u8 and write 26.6 MB of f32 per view: about 0.018 ms at
// 3.35 TB/s with both views, 0.010 ms with the strong view alone.
//
// Design, two launches, no scratch image, no atomics:
// 1. gray_partials_kernel: kPartials blocks per image, each the f64 sum of
//    gray(b * x) over its contiguous share of the canvas, read 16 pixels
//    (48 bytes, three 16-byte loads) a thread at a time, into its own slot.
//    Images whose jitter gate is off exit at once.
// 2. tile_kernel: a block per 16 x 64 tile of one image. It sums the
//    image's partials in a fixed order (so every block, and every run, sees
//    the same mean), stages the u8 tile with its 4-pixel halo in shared
//    memory by 16-byte loads, computes the jittered and grayed value of
//    each staged pixel once (0 outside the canvas: the blur zero-pads the
//    photometric image), runs the vertical 9-tap pass in place (a thread
//    per float column, the column in registers) and the horizontal one from
//    registers (a thread per 4 output pixels and the 8 around them), taps
//    t = 0..8 in order as the plain version's _shifted_sum adds them,
//    solarizes and normalises; the tile rows of both views go through
//    shared memory and leave as contiguous 16-byte stores (single stores
//    at the ends of a row that is off 16 bytes). Images whose blur gate is
//    off stage no halo and skip both passes. u8 / 255 and the weak view's
//    per-channel value are 256-entry tables in shared memory. Six blocks
//    an SM. Hand-built variants timed on the card were slower: the
//    vertical pass into a second buffer (five blocks an SM), and each
//    thread storing its own 12 floats (48-byte strides across a warp).
//    The stores alone, without the arithmetic, take well under the whole:
//    the kernel is bound by its instructions and their latency, not by
//    the bytes.
// Arithmetic is correctly rounded intrinsics in the order of the plain
// version, so no FMA contraction separates the two.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kParams = 20;     // per image, see coin_augment's comment
constexpr int kRadius = 4;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kPartials = 128;  // gray-mean partials per image
constexpr int kTH = 16;         // tile rows
constexpr int kTW = 64;         // tile columns
constexpr int kRows = kTH + 2 * kRadius;
constexpr int kRowF = 3 * (kTW + 2 * kRadius);  // floats of a staged row
// bytes of a staged u8 row: the tile's bytes plus up to 15 before and
// after, so that whole aligned 16-byte pieces land in it
constexpr int kRowU = ((kRowF + 32) + 15) / 16 * 16;
constexpr int kGroups = (3 * kTW) / 4 + 2;      // 16-byte groups of a row
// the photometric image, then the two views' tile rows
constexpr int kP = kRows * kRowF > 2 * kTH * 3 * kTW ? kRows * kRowF
                                                     : 2 * kTH * 3 * kTW;

struct Norm {
  float mean[3];
  float std[3];
};

__device__ __forceinline__ float gray3(float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r, 0.299f), __fmul_rn(g, 0.587f)),
                   __fmul_rn(b, 0.114f));
}

// the jittered and grayed value of one pixel (3 channels) from its bytes;
// unit[i] = i / 255
__device__ __forceinline__ void photometric(const uint8_t* px,
                                            const float* unit, bool jitter,
                                            bool gray, const float* p,
                                            float mean, float* v) {
  v[0] = unit[px[0]];
  v[1] = unit[px[1]];
  v[2] = unit[px[2]];
  if (jitter) {
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
  if (gray) {
    const float g = gray3(v[0], v[1], v[2]);
    v[0] = g; v[1] = g; v[2] = g;
  }
}

__device__ __forceinline__ void unpack16(const uint4& q, uint8_t* d) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
}

__global__ void __launch_bounds__(kThreads)
gray_partials_kernel(const uint8_t* __restrict__ img,
                     const float* __restrict__ params,
                     double* __restrict__ partials, int HW) {
  __shared__ float unit[256];
  __shared__ double warp_sums[kThreads / 32];
  const int b = blockIdx.y;
  const float* p = params + b * kParams;
  if (p[0] == 0.0f) return;
  unit[threadIdx.x] = __fdiv_rn((float)threadIdx.x, 255.0f);
  __syncthreads();
  const uint8_t* base = img + (size_t)b * HW * 3;
  const float bright = p[4];
  // this block's groups of 16 pixels (48 bytes)
  const int groups = (HW + 15) / 16;
  const int g0 = (int)((long long)groups * blockIdx.x / kPartials);
  const int g1 = (int)((long long)groups * (blockIdx.x + 1) / kPartials);
  const bool vec = ((uintptr_t)base & 15) == 0;
  double acc = 0.0;
  for (int g = g0 + threadIdx.x; g < g1; g += kThreads) {
    const int px0 = g * 16;
    if (vec && px0 + 16 <= HW) {
      const uint4* q = reinterpret_cast<const uint4*>(base + (size_t)px0 * 3);
      uint8_t d[48];
      unpack16(__ldg(q), d);
      unpack16(__ldg(q + 1), d + 16);
      unpack16(__ldg(q + 2), d + 32);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        acc += (double)gray3(__fmul_rn(unit[d[3 * i]], bright),
                             __fmul_rn(unit[d[3 * i + 1]], bright),
                             __fmul_rn(unit[d[3 * i + 2]], bright));
      }
    } else {
      for (int i = px0; i < min(px0 + 16, HW); ++i) {
        const uint8_t* px = base + (size_t)i * 3;
        acc += (double)gray3(__fmul_rn(unit[px[0]], bright),
                             __fmul_rn(unit[px[1]], bright),
                             __fmul_rn(unit[px[2]], bright));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffff, acc, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) t += warp_sums[w];
    partials[(size_t)b * kPartials + blockIdx.x] = t;
  }
}

// Copy the floats [0, len) of one tile row from shared memory (src) to
// its output row (dst): a 16-byte store for each aligned group of four and
// single stores at the row's ends. `slot` < kGroups names the group, from
// the one that holds dst[0].
__device__ __forceinline__ void store_group(float* dst, const float* src,
                                            int len, int slot) {
  const int head = (int)(((uintptr_t)dst >> 2) & 3);  // dst[0]'s place
  const int j0 = slot * 4 - head;                     // the group's first
  if (j0 >= len) return;
  if (j0 >= 0 && j0 + 4 <= len) {
    *reinterpret_cast<float4*>(dst + j0) =
        head == 0 ? *reinterpret_cast<const float4*>(src + j0)
                  : make_float4(src[j0], src[j0 + 1], src[j0 + 2],
                                src[j0 + 3]);
    return;
  }
  for (int j = max(j0, 0); j < min(j0 + 4, len); ++j) dst[j] = src[j];
}

// six blocks an SM: 34.8 KB of shared memory and at most 40 registers each
__global__ void __launch_bounds__(kThreads, 6)
tile_kernel(const uint8_t* __restrict__ img, const float* __restrict__ params,
            const double* __restrict__ partials, float* __restrict__ strong,
            float* __restrict__ weak, int H, int W, Norm n) {
  // the photometric image; its first th rows then hold the vertical pass;
  // last, the two views' tile rows
  __shared__ __align__(16) float P[kP];
  __shared__ __align__(16) uint8_t U[kRows * kRowU];  // the staged bytes
  __shared__ float unit[256];
  __shared__ float weak_of[3][256];
  __shared__ float mean_s;
  const int t = threadIdx.x;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int th = min(kTH, H - y0), tw = min(kTW, W - x0);
  const float* p = params + b * kParams;
  const bool jitter = p[0] != 0.0f, gray = p[1] != 0.0f;
  const bool blur = p[2] != 0.0f, solarize = p[3] != 0.0f;
  const int halo = blur ? kRadius : 0;
  const int ys = y0 - halo, xs = x0 - halo;      // the staged region
  const int nr = th + 2 * halo, nc = tw + 2 * halo;
  const int cx0 = max(xs, 0), cx1 = min(xs + nc, W);  // its canvas columns
  const uint8_t* image = img + (size_t)b * H * W * 3;
  const uint8_t* img_end = img + (size_t)gridDim.z * H * W * 3;

  {
    const float u = __fdiv_rn((float)t, 255.0f);
    unit[t] = u;
    if (weak != nullptr) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        weak_of[c][t] = __fdiv_rn(__fsub_rn(u, n.mean[c]), n.std[c]);
      }
    }
  }
  if (t < 32) {
    // warp 0: the image's mean gray, its partials summed in a fixed order
    if (jitter) {
      const double* ps = partials + (size_t)b * kPartials;
      double s = 0.0;
      for (int i = t; i < kPartials; i += 32) s += ps[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_down_sync(0xffffffff, s, o);
      }
      if (t == 0) mean_s = (float)(s / ((double)H * W));
    }
  } else {
    // the other warps stage the canvas bytes of each staged row: the
    // aligned 16-byte pieces that cover them, each stored whole at the
    // same phase in the row's slot
    for (int idx = t - 32; idx < nr * (kRowU / 16); idx += kThreads - 32) {
      const int r = idx / (kRowU / 16), k = idx - r * (kRowU / 16);
      const int y = ys + r;
      if (y < 0 || y >= H || cx0 >= cx1) continue;
      const uint8_t* lo = image + ((size_t)y * W + cx0) * 3;
      const uint8_t* hi = image + ((size_t)y * W + cx1) * 3;
      const uint8_t* a0 = (const uint8_t*)((uintptr_t)lo & ~(uintptr_t)15);
      const uint8_t* piece = a0 + 16 * k;
      if (piece >= hi) continue;
      uint8_t* dst = U + r * kRowU + 16 * k;
      if (piece >= img && piece + 16 <= img_end) {
        *reinterpret_cast<uint4*>(dst) = __ldg(
            reinterpret_cast<const uint4*>(piece));
      } else {
        for (int i = 0; i < 16; ++i) {
          if (piece + i >= lo && piece + i < hi) dst[i] = piece[i];
        }
      }
    }
  }
  __syncthreads();
  const float mean = jitter ? mean_s : 0.0f;
  // the bytes of staged pixel (r, j), a canvas pixel
  auto bytes = [&](int r, int j) -> const uint8_t* {
    const uint8_t* lo = image + ((size_t)(ys + r) * W + cx0) * 3;
    return U + r * kRowU + ((uintptr_t)lo & 15) + 3 * (xs + j - cx0);
  };
  constexpr int kCols = kTW + 2 * kRadius;
  for (int idx = t; idx < nr * kCols; idx += kThreads) {
    const int r = idx / kCols, j = idx - r * kCols;
    if (j >= nc) continue;
    const int y = ys + r, x = xs + j;
    float v[3] = {0.0f, 0.0f, 0.0f};
    if (y >= 0 && y < H && x >= 0 && x < W) {
      photometric(bytes(r, j), unit, jitter, gray, p, mean, v);
    }
    float* o = P + r * kRowF + 3 * j;
    o[0] = v[0]; o[1] = v[1]; o[2] = v[2];
  }
  __syncthreads();
  float k[kTaps];
#pragma unroll
  for (int i = 0; i < kTaps; ++i) k[i] = p[8 + i];
  if (blur) {
    // along y: a thread owns one float column of the staged rows, reads it
    // whole into registers and writes the pass over its first th rows in
    // place (rows past nr feed only rows past th)
    for (int f = t; f < 3 * nc; f += kThreads) {
      float col[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) col[i] = P[i * kRowF + f];
#pragma unroll
      for (int r = 0; r < kTH; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < kTaps; ++i) {
          acc = __fadd_rn(acc, __fmul_rn(k[i], col[r + i]));
        }
        if (r < th) P[r * kRowF + f] = acc;
      }
    }
    __syncthreads();
  }
  // along x, solarize, normalise: thread t owns the 4 pixels xl .. xl + 3
  // of tile row r, and the weak view's values of the same pixels
  static_assert(kTH * kTW / 4 == kThreads, "a thread per 4 pixels");
  const int r = t / (kTW / 4), xl = 4 * (t % (kTW / 4));
  const bool mine = r < th && xl < tw;
  float v[12], w[12];
  if (mine) {
    if (blur) {
      // the 12 staged pixels xl .. xl + 11 around them (those past nc
      // feed only pixels past tw)
      float win[36];
#pragma unroll
      for (int i = 0; i < 36; ++i) win[i] = P[r * kRowF + 3 * xl + i];
#pragma unroll
      for (int q = 0; q < 12; ++q) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < kTaps; ++i) {
          acc = __fadd_rn(acc, __fmul_rn(k[i], win[q + 3 * i]));
        }
        v[q] = acc;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 12; ++q) v[q] = P[r * kRowF + 3 * xl + q];
    }
#pragma unroll
    for (int q = 0; q < 12; ++q) {
      float u = v[q];
      if (solarize && u >= 0.5f) u = __fsub_rn(1.0f, u);
      v[q] = __fdiv_rn(__fsub_rn(u, n.mean[q % 3]), n.std[q % 3]);
    }
    if (weak != nullptr) {
      const uint8_t* px = bytes(r + halo, halo + xl);
      const int np = min(4, tw - xl);
#pragma unroll
      for (int q = 0; q < 12; ++q) {
        w[q] = q < 3 * np ? weak_of[q % 3][px[q]] : 0.0f;
      }
    }
  }
  // through shared memory, so that each view's tile rows leave as
  // contiguous 16-byte stores
  __syncthreads();
  float* out_s = P;                       // [kTH][3 * kTW] each
  float* out_w = P + kTH * 3 * kTW;
  if (mine) {
    float4* os = reinterpret_cast<float4*>(out_s + r * 3 * kTW + 3 * xl);
    float4* ow = reinterpret_cast<float4*>(out_w + r * 3 * kTW + 3 * xl);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      os[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      if (weak != nullptr) {
        ow[i] = make_float4(w[4 * i], w[4 * i + 1], w[4 * i + 2],
                            w[4 * i + 3]);
      }
    }
  }
  __syncthreads();
  const size_t row0 = ((size_t)b * H + y0) * W + x0;
  for (int idx = t; idx < th * kGroups; idx += kThreads) {
    const int rr = idx / kGroups, slot = idx - rr * kGroups;
    const size_t at = (row0 + (size_t)rr * W) * 3;
    store_group(strong + at, out_s + rr * 3 * kTW, 3 * tw, slot);
    if (weak != nullptr) {
      store_group(weak + at, out_w + rr * 3 * kTW, 3 * tw, slot);
    }
  }
}

}  // namespace

// img: (B, H, W, 3) u8; params: (B, 20) f32 per image = gates (jitter,
// gray, blur, solarize; 1 = on), brightness, contrast, saturation, hue,
// the 9 normalised blur taps, 3 unused; partials: B * 128 f64, written by
// the first launch and read by the second; strong: (B, H, W, 3) f32; weak:
// (B, H, W, 3) f32, or null for the strong view alone. All on one device,
// the float outputs 4-byte aligned. Returns the first CUDA error code of
// the two launches.
extern "C" int coin_augment(const void* img, const void* params,
                            void* partials, void* strong, void* weak, int B,
                            int H, int W, const float* mean,
                            const float* std, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  Norm n;
  for (int c = 0; c < 3; ++c) {
    n.mean[c] = mean[c];
    n.std[c] = std[c];
  }
  gray_partials_kernel<<<dim3(kPartials, B), kThreads, 0, s>>>(
      (const uint8_t*)img, (const float*)params, (double*)partials, H * W);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  tile_kernel<<<grid, kThreads, 0, s>>>(
      (const uint8_t*)img, (const float*)params, (const double*)partials,
      (float*)strong, (float*)weak, H, W, n);
  return (int)cudaGetLastError();
}
