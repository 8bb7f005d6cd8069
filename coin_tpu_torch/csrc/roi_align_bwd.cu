// K1b · RoIAlign backward (aligned=True, static sampling ratio) for Hopper:
// the gradient of the features; the RoIs get none (proposals and sampled
// boxes are constants of the step).
//
// Replaces: the autodiff transpose of coin_tpu/ops/roi_align.py
// `roi_align`'s two interpolation-matrix einsums (:85-94), which XLA runs as
// two dense contractions on the TPU. Here each output cell scatters its
// incoming gradient into the 4 bilinear taps of each of its s x s samples.
//
// Bound: bytes. At the training shapes (3 images x 576 rois, 14x14, 1024
// channels, bf16) the kernel must read the 693 MB gradient once and write
// the 12 MB feature gradient once: about 0.21 ms at 3.35 TB/s. Design: one
// thread per (roi, output cell, 8-channel vector); a warp covers 256
// consecutive channels of one cell, so its loads are one contiguous run and
// its atomics land on 32 consecutive 32-byte segments. The sample
// coordinates and tap weights are recomputed exactly as csrc/roi_align.cu
// does (correctly rounded intrinsics in the JAX order); the gradient is
// scaled by the 1/(s*s) sample mean and added into an f32 (B, H, W, C)
// buffer with 16-byte vector atomics (sm_90). The samples' row and column
// weights are merged per distinct tap first, so a cell issues one atomic
// per tap it touches (4 to 16 for 2 x 2 samples; the first version always
// issued 16). Those atomics, through L2, are what keep the kernel far from
// its bound. The caller casts the buffer to the features' dtype; the sum
// order follows the atomics, so results vary in the last bits from run to
// run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#if defined(__CUDACC_VER_MAJOR__) &&                                     \
    (__CUDACC_VER_MAJOR__ > 12 ||                                        \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 5))
#define COIN_VECTOR_ATOMICS 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSampling = 4;
constexpr int kMaxTaps = 2 * kMaxSampling;

struct Tap {
  int lo, hi;
  float wlo, whi;   // both 0 when the sample is outside [-1, size]
};

__device__ __forceinline__ Tap make_tap(float pos, int size) {
  Tap t;
  if (pos < -1.0f || pos > (float)size) {
    t.lo = 0; t.hi = 0; t.wlo = 0.0f; t.whi = 0.0f;
    return t;
  }
  float p = fminf(fmaxf(pos, 0.0f), (float)(size - 1));
  int lo = (int)floorf(p);
  t.lo = lo;
  t.hi = min(lo + 1, size - 1);
  float l = p - (float)lo;
  t.wlo = 1.0f - l;
  t.whi = l;
  return t;
}

// add weight w to index i of a short list of distinct indices
__device__ __forceinline__ void merge(int* idx, float* wt, int& n, int i,
                                      float w) {
  if (w == 0.0f) return;
  for (int k = 0; k < n; ++k) {
    if (idx[k] == i) {
      wt[k] = __fadd_rn(wt[k], w);
      return;
    }
  }
  idx[n] = i;
  wt[n] = w;
  ++n;
}

template <typename T, int V> struct Load;
template <> struct Load<float, 1> {
  static __device__ __forceinline__ void run(const float* p, float* v) {
    v[0] = *p;
  }
};
template <> struct Load<float, 4> {
  static __device__ __forceinline__ void run(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};
template <> struct Load<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float* v) {
    v[0] = __bfloat162float(*p);
  }
};
template <> struct Load<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
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
};

// dst[0:V] += w * g[0:V]; V is 1 or a multiple of 4 (16-byte aligned dst)
template <int V>
__device__ __forceinline__ void scatter(float* dst, float w, const float* g) {
  if constexpr (V == 1) {
    atomicAdd(dst, __fmul_rn(w, g[0]));
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
#ifdef COIN_VECTOR_ATOMICS
      atomicAdd(reinterpret_cast<float4*>(dst + i),
                make_float4(__fmul_rn(w, g[i]), __fmul_rn(w, g[i + 1]),
                            __fmul_rn(w, g[i + 2]), __fmul_rn(w, g[i + 3])));
#else
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        atomicAdd(dst + i + j, __fmul_rn(w, g[i + j]));
      }
#endif
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
roi_align_bwd_kernel(const T* __restrict__ grad,
                     const float* __restrict__ rois,
                     float* __restrict__ dfeat, int H, int W, int C,
                     int rois_per_image, float spatial_scale, int res,
                     int sampling, long long total) {
  const int lanes = C / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int c = (int)(i % lanes) * V;
    const long long cell = i / lanes;
    const int pw = (int)(cell % res);
    const int ph = (int)((cell / res) % res);
    const long long roi = cell / ((long long)res * res);
    const int b = (int)(roi / rois_per_image);

    const float* r = rois + 4 * roi;
    const float x1 = __fsub_rn(__fmul_rn(r[0], spatial_scale), 0.5f);
    const float y1 = __fsub_rn(__fmul_rn(r[1], spatial_scale), 0.5f);
    const float x2 = __fsub_rn(__fmul_rn(r[2], spatial_scale), 0.5f);
    const float y2 = __fsub_rn(__fmul_rn(r[3], spatial_scale), 0.5f);
    const float bin_w = __fdiv_rn(__fsub_rn(x2, x1), (float)res);
    const float bin_h = __fdiv_rn(__fsub_rn(y2, y1), (float)res);

    float g[V];
    Load<T, V>::run(grad + cell * C + c, g);
    const float inv = 1.0f / (float)(sampling * sampling);
#pragma unroll
    for (int v = 0; v < V; ++v) g[v] = __fmul_rn(g[v], inv);

    // The s x s samples' weights are separable: the weight of tap (y, x)
    // is (sum over y-samples of its row weight) x (sum over x-samples of
    // its column weight). Merging equal rows and columns first makes one
    // atomic per distinct tap: 4 to 16 per cell instead of always 16.
    int ys[kMaxTaps], xs[kMaxTaps];
    float wy[kMaxTaps], wx[kMaxTaps];
    int ny = 0, nx = 0;
    for (int k = 0; k < sampling; ++k) {
      const float off = __fdiv_rn((float)k + 0.5f, (float)sampling);
      const Tap ty = make_tap(
          __fadd_rn(y1, __fmul_rn(__fadd_rn((float)ph, off), bin_h)), H);
      merge(ys, wy, ny, ty.lo, ty.wlo);
      merge(ys, wy, ny, ty.hi, ty.whi);
      const Tap tx = make_tap(
          __fadd_rn(x1, __fmul_rn(__fadd_rn((float)pw, off), bin_w)), W);
      merge(xs, wx, nx, tx.lo, tx.wlo);
      merge(xs, wx, nx, tx.hi, tx.whi);
    }
    float* base = dfeat + (size_t)b * H * W * C + c;
    for (int a = 0; a < ny; ++a) {
      for (int e = 0; e < nx; ++e) {
        scatter<V>(base + ((size_t)ys[a] * W + xs[e]) * C,
                   __fmul_rn(wy[a], wx[e]), g);
      }
    }
  }
}

template <typename T, int V>
int launch(const void* grad, const void* rois, void* dfeat, int H, int W,
           int C, int total_rois, int rois_per_image, float spatial_scale,
           int res, int sampling, cudaStream_t s) {
  const long long total = (long long)total_rois * res * res * (C / V);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  roi_align_bwd_kernel<T, V><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const T*)grad, (const float*)rois, (float*)dfeat, H, W, C,
      rois_per_image, spatial_scale, res, sampling, total);
  return (int)cudaGetLastError();
}

}  // namespace

// grad: (total_rois, res, res, C) of dtype (0 = float32, 1 = bfloat16);
// rois: (total_rois, 4) float32, image b owning rows [b * rois_per_image,
// (b + 1) * rois_per_image); dfeat: a zeroed (B, H, W, C) float32 buffer
// that the kernel adds into. Returns the CUDA error code of the launch.
extern "C" int coin_roi_align_bwd(const void* grad, const void* rois,
                                  void* dfeat, int H, int W, int C,
                                  int total_rois, int rois_per_image,
                                  float spatial_scale, int res, int sampling,
                                  int dtype, void* stream) {
  if (total_rois <= 0 || res <= 0 || sampling <= 0 ||
      sampling > kMaxSampling) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = (((uintptr_t)grad | (uintptr_t)dfeat) % 16) == 0;
  if (dtype == 0) {
    return (aligned && C % 4 == 0)
        ? launch<float, 4>(grad, rois, dfeat, H, W, C, total_rois,
                           rois_per_image, spatial_scale, res, sampling, s)
        : launch<float, 1>(grad, rois, dfeat, H, W, C, total_rois,
                           rois_per_image, spatial_scale, res, sampling, s);
  }
  if (dtype == 1) {
    return (aligned && C % 8 == 0)
        ? launch<__nv_bfloat16, 8>(grad, rois, dfeat, H, W, C, total_rois,
                                   rois_per_image, spatial_scale, res,
                                   sampling, s)
        : launch<__nv_bfloat16, 1>(grad, rois, dfeat, H, W, C, total_rois,
                                   rois_per_image, spatial_scale, res,
                                   sampling, s);
  }
  return (int)cudaErrorInvalidValue;
}
