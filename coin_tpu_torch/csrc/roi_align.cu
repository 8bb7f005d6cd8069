// K1 · RoIAlign forward (aligned=True, static sampling ratio) for Hopper.
//
// Replaces: coin_tpu/ops/roi_align.py `roi_align` / `roi_align_batched`,
// which the JAX package writes as two dense interpolation-matrix einsums
// because gathers are slow on a TPU. On this card a gather is cheap, so the
// kernel reads the four bilinear taps of each sample directly.
//
// Bound: the output. At the shipped eval shapes (4 images x 1000 rois,
// 14x14, 1024 channels, bf16) the kernel writes 1.6 GB and reads a 24 MB
// res4 map that stays in the 50 MB L2, so it is bound by the output write
// at 3.35 TB/s. Design: one block per (roi, output row); threads run along
// the channels, 8 bf16 (or 4 f32) per thread as one 16-byte load or store,
// so every feature load and every output store of a warp is one contiguous
// 512-byte NHWC run. Each output element is the mean of s x s samples x 4
// taps accumulated in f32 and rounded to the output type once. The
// per-sample coordinates and tap weights of the block's row and of all
// output columns are computed once into shared memory.
//
// Semantics (coin_tpu/ops/roi_align.py:28-95): roi * scale - 0.5; sample
// k of cell r at start + (r + (k + 0.5) / s) * bin; a sample outside
// [-1, size] contributes 0; inside, it is clamped to [0, size - 1].

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxRes = 32;      // resolution * sampling_ratio <= kMaxRes
constexpr int kThreads = 256;

struct Tap {
  int lo, hi;       // neighbouring grid rows (or columns)
  float wlo, whi;   // their weights; both 0 when the sample is outside
};

__device__ __forceinline__ Tap make_tap(float pos, int size) {
  Tap t;
  if (pos < -1.0f || pos > (float)size) {
    t.lo = 0; t.hi = 0; t.wlo = 0.0f; t.whi = 0.0f;
    return t;
  }
  float p = fminf(fmaxf(pos, 0.0f), (float)(size - 1));
  int lo = (int)floorf(p);
  int hi = min(lo + 1, size - 1);
  float l = p - (float)lo;
  t.lo = lo; t.hi = hi; t.wlo = 1.0f - l; t.whi = l;
  return t;
}

// V consecutive channels of one pixel as one access: 16 bytes (8 bf16 or
// 4 f32) where the channel count and the pointers allow, else 1 element.
template <typename T, int V> struct Vec;
template <> struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = *p;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *p = v[0];
  }
};
template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    *p = __float2bfloat16(v[0]);
  }
};
template <> struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = q;
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(const T* __restrict__ feats,
                     const float* __restrict__ rois,
                     T* __restrict__ out, int H, int W, int C,
                     int rois_per_image, float spatial_scale, int res,
                     int sampling) {
  const int roi = blockIdx.x;
  const int ph = blockIdx.y;
  const int b = roi / rois_per_image;

  // Sample coordinates with explicitly rounded intrinsics, in the order of
  // the JAX op and the plain version: a contracted FMA would move a
  // coordinate by an ulp and a tap weight by ~1e-5 at the far edge.
  __shared__ Tap ytap[kMaxRes];
  __shared__ Tap xtap[kMaxRes];
  const float* r = rois + 4 * (size_t)roi;
  const float x1 = __fsub_rn(__fmul_rn(r[0], spatial_scale), 0.5f);
  const float y1 = __fsub_rn(__fmul_rn(r[1], spatial_scale), 0.5f);
  const float x2 = __fsub_rn(__fmul_rn(r[2], spatial_scale), 0.5f);
  const float y2 = __fsub_rn(__fmul_rn(r[3], spatial_scale), 0.5f);
  const float bin_w = __fdiv_rn(__fsub_rn(x2, x1), (float)res);
  const float bin_h = __fdiv_rn(__fsub_rn(y2, y1), (float)res);
  const int ns = res * sampling;
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const int cell = i / sampling, k = i % sampling;
    const float off = __fdiv_rn((float)k + 0.5f, (float)sampling);
    xtap[i] = make_tap(
        __fadd_rn(x1, __fmul_rn(__fadd_rn((float)cell, off), bin_w)), W);
  }
  for (int k = threadIdx.x; k < sampling; k += blockDim.x) {
    const float off = __fdiv_rn((float)k + 0.5f, (float)sampling);
    ytap[k] = make_tap(
        __fadd_rn(y1, __fmul_rn(__fadd_rn((float)ph, off), bin_h)), H);
  }
  __syncthreads();

  const float inv = 1.0f / (float)(sampling * sampling);
  const T* fb = feats + (size_t)b * H * W * C;
  T* ob = out + (((size_t)roi * res + ph) * res) * C;
  for (int pw = 0; pw < res; ++pw) {
    for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.0f;
      for (int iy = 0; iy < sampling; ++iy) {
        const Tap ty = ytap[iy];
        const T* rlo = fb + (size_t)ty.lo * W * C + c;
        const T* rhi = fb + (size_t)ty.hi * W * C + c;
        for (int ix = 0; ix < sampling; ++ix) {
          const Tap tx = xtap[pw * sampling + ix];
          const size_t xl = (size_t)tx.lo * C, xh = (size_t)tx.hi * C;
          float a[V], bb[V], cc[V], d[V];
          Vec<T, V>::load(rlo + xl, a);
          Vec<T, V>::load(rlo + xh, bb);
          Vec<T, V>::load(rhi + xl, cc);
          Vec<T, V>::load(rhi + xh, d);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[v] += ty.wlo * (tx.wlo * a[v] + tx.whi * bb[v])
                    + ty.whi * (tx.wlo * cc[v] + tx.whi * d[v]);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] *= inv;
      Vec<T, V>::store(ob + (size_t)pw * C + c, acc);
    }
  }
}

template <typename T, int V>
int launch(const void* feats, const void* rois, void* out, int H, int W,
           int C, int total_rois, int rois_per_image, float spatial_scale,
           int res, int sampling, cudaStream_t s) {
  const int lanes = C / V;
  dim3 grid(total_rois, res);
  dim3 block(lanes < kThreads ? ((lanes + 31) / 32) * 32 : kThreads);
  roi_align_fwd_kernel<T, V><<<grid, block, 0, s>>>(
      (const T*)feats, (const float*)rois, (T*)out, H, W, C, rois_per_image,
      spatial_scale, res, sampling);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. rois: (total_rois, 4) float32, image
// b owns rows [b * rois_per_image, (b + 1) * rois_per_image). Returns the
// CUDA error code of the launch (0 on success).
extern "C" int coin_roi_align_fwd(const void* feats, const void* rois,
                                  void* out, int H, int W, int C,
                                  int total_rois, int rois_per_image,
                                  float spatial_scale, int res, int sampling,
                                  int dtype, void* stream) {
  if (res * sampling > kMaxRes || total_rois <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = (((uintptr_t)feats | (uintptr_t)out) % 16) == 0;
  if (dtype == 0) {
    return (aligned && C % 4 == 0)
        ? launch<float, 4>(feats, rois, out, H, W, C, total_rois,
                           rois_per_image, spatial_scale, res, sampling, s)
        : launch<float, 1>(feats, rois, out, H, W, C, total_rois,
                           rois_per_image, spatial_scale, res, sampling, s);
  }
  if (dtype == 1) {
    return (aligned && C % 8 == 0)
        ? launch<__nv_bfloat16, 8>(feats, rois, out, H, W, C, total_rois,
                                   rois_per_image, spatial_scale, res,
                                   sampling, s)
        : launch<__nv_bfloat16, 1>(feats, rois, out, H, W, C, total_rois,
                                   rois_per_image, spatial_scale, res,
                                   sampling, s);
  }
  return (int)cudaErrorInvalidValue;
}
