// K1 · RoIAlign forward (aligned=True, static sampling ratio) for Hopper.
//
// Replaces: coin_tpu/ops/roi_align.py `roi_align` / `roi_align_batched`,
// which the JAX package writes as two dense interpolation-matrix einsums
// because gathers are slow on a TPU:
//   out[r][s][c] = sum_y sum_x ay[r][y] ax[s][x] F[y][x][c]
// with ay (R, H) and ax (R, W) the RoI's row and column weights, each the
// mean of its s samples' bilinear taps.
//
// Bound: the output. At the eval shapes (4 images x 1000 RoIs, 14x14, 1024
// channels, bf16) the kernel must write 1.6 GB and read a 24 MB res4 map
// that stays in the 50 MB L2: about 0.49 ms at 3.35 TB/s.
//
// Design: a block per RoI and 16 channel vectors (128 bf16 or 64 f32
// channels, 16 bytes a thread), the separable form in the plain version's
// order, with one axis's contraction in registers. The first version ran
// a block per (RoI, output row) whose threads walked the 14 output columns
// and issued, for each 16-byte output, its 2 x 2 samples x 4 taps as 16
// separate 16-byte loads, each converted and weighted on its own. Here:
// 1. 2R threads give each cell of each axis its distinct taps in ascending
//    order with their weights: the mean of its samples' tents, summed in
//    sample order (csrc/roi_taps.cuh: correctly rounded intrinsics in the
//    JAX order; samples outside [-1, size] weigh 0, the rest are clamped),
//    in registers; once per block;
// 2. the longer axis goes first, as in the plain version (x when W >= H): a
//    thread owns one cell of that axis (its output column when x goes
//    first) and a vector, and walks the cells of the other axis in order;
//    at each of a walked cell's taps it needs the contraction along its
//    own axis, sum_k w[k] F[..], and keeps the last two in registers, so a
//    walked tap it already holds costs V FMAs and a new one a load of each
//    of its own cell's taps, all issued before the first is used. So a
//    thread loads each feature pixel it reads about once, where the first
//    version loaded it for each sample that taps it: counted from the
//    taps, 15 times fewer loads on a RoI of the trainer's median side (83
//    px), 6.8 times fewer on chip_smoke.py's random eval RoIs (2-600 px),
//    1.4 times fewer on a RoI as large as the map;
// 3. each output is the walked cell's weights times the held contractions,
//    summed in f32 and rounded once to the output type, stored as one
//    16-byte streaming store (a warp writes 2 x 256 contiguous bytes, and
//    the stores do not displace the feature map from L2).
// Every sum is a chain of FMAs over ascending taps, as the plain version's
// two contractions are on the CPU, so the f32 result equals the plain
// version's there to the bit or nearly (a walk in the other order put the
// card's f32 detector 1.07e-3 from the CPU's after res5, over the 1e-3 of
// chip_smoke.py's reference phase). Every branch of the walk depends on
// the RoI's taps alone, the same for all the block's threads. The feature
// loads go through L1: the threads of one RoI read the same few pixels at
// about the same time. No RoI needs tiling, whatever its size. The walk is
// bound by its own latency (without its feature loads it keeps most of its
// time), so up to 14 rows the kernel is built for four blocks an SM. A
// second vector a thread, prefetches of the next taps into registers or
// L1, and a block walking several channel tiles were all slower.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "roi_taps.cuh"

namespace {

constexpr int kMaxRes = 32;      // resolution * sampling_ratio <= kMaxRes
constexpr int kMaxS = 4;         // sampling_ratio <= kMaxS
constexpr int kNV = 16;          // channel vectors (threads) per output row
constexpr int kFewRows = 14;     // resolutions built for 4 blocks an SM

// V consecutive channels of one pixel as one access: 16 bytes (8 bf16 or
// 4 f32) where the channel count and the pointers allow, else 1 element.
// fetch issues the load; unpack converts what arrived to f32.
template <typename T, int V> struct Vec;
template <> struct Vec<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw fetch(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
    v[0] = q;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *p = v[0];
  }
};
template <> struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw fetch(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(v[0], v[1], v[2], v[3]));
  }
};
template <> struct Vec<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ Raw fetch(const __nv_bfloat16* p) {
    return *p;
  }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
    v[0] = __bfloat162float(q);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    *p = __float2bfloat16(v[0]);
  }
};
template <> struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw fetch(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
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
    __stcs(reinterpret_cast<uint4*>(p), q);
  }
};

// kRows: the most output rows (resolution) a launch may have; up to
// kFewRows the kernel is held to four resident blocks an SM
template <typename T, int V, int S, int kRows>
__global__ void __launch_bounds__(kRows * kNV, kRows <= kFewRows ? 4 : 1)
roi_align_fwd_kernel(const T* __restrict__ feats,
                     const float* __restrict__ rois,
                     T* __restrict__ out, int H, int W, int C,
                     int rois_per_image, float spatial_scale, int R) {
  constexpr int kTaps = 2 * S;      // distinct taps of a cell along an axis
  // each cell's distinct taps along x (axis 0) and y (axis 1) in ascending
  // order, with their weights (the mean of the cell's samples' tents)
  __shared__ int ntaps[2][kRows];
  __shared__ float2 taps[2][kRows][kTaps];   // {tap index bits, weight}

  const int t = threadIdx.x;
  const long long roi = blockIdx.x;
  const int b = (int)(roi / rois_per_image);
  if (t < 2 * R) {
    const roi_taps::Frame f =
        roi_taps::frame(rois + 4 * roi, spatial_scale, R);
    const int axis = t / R, cell = t % R;
    // the cell's 2s taps in sample order; a tap met again adds its weight
    // into the first (the sum in sample order, as the plain version's
    // mean); then ascending, all in registers
    int ix[kTaps];
    float w[kTaps];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const roi_taps::Tap tp =
          axis ? roi_taps::sample_tap(f.y1, f.bin_h, cell, k, S, H)
               : roi_taps::sample_tap(f.x1, f.bin_w, cell, k, S, W);
      ix[2 * k] = tp.in ? tp.lo : INT_MAX;
      w[2 * k] = tp.wlo;
      ix[2 * k + 1] = tp.in ? tp.hi : INT_MAX;
      w[2 * k + 1] = tp.whi;
    }
#pragma unroll
    for (int j = 1; j < kTaps; ++j) {
#pragma unroll
      for (int i = 0; i < j; ++i) {
        if (ix[j] != INT_MAX && ix[i] == ix[j]) {
          w[i] += w[j];
          ix[j] = INT_MAX;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kTaps - 1; ++m) {
#pragma unroll
      for (int j = 0; j + 1 < kTaps - m; ++j) {
        if (ix[j] > ix[j + 1]) {
          const int ti = ix[j];
          ix[j] = ix[j + 1];
          ix[j + 1] = ti;
          const float tw = w[j];
          w[j] = w[j + 1];
          w[j + 1] = tw;
        }
      }
    }
    int n = 0;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      if (ix[j] != INT_MAX) {
        taps[axis][cell][j] =
            make_float2(__int_as_float(ix[j]), __fdiv_rn(w[j], (float)S));
        n = j + 1;
      }
    }
    ntaps[axis][cell] = n;
  }
  __syncthreads();

  // the plain version's order: the longer axis first. A thread holds one
  // cell of that axis (its output column when x goes first, its output row
  // otherwise) and walks the cells of the other.
  const bool xfirst = W >= H;
  const int fa = xfirst ? 0 : 1, wa = 1 - fa;
  const int v = t % kNV, own = t / kNV;
  const int c = (blockIdx.y * kNV + v) * V;
  if (c >= C) return;
  const int fstride = xfirst ? C : W * C;    // a tap of the thread's axis
  const int wstride = xfirst ? W * C : C;    // a tap of the walked axis
  const int ostride = (xfirst ? R : 1) * C;  // a walked cell's output
  const T* fb = feats + (long long)b * H * W * C + c;
  T* ob = out + ((roi * R + (xfirst ? 0 : own)) * R + (xfirst ? own : 0)) * C
          + c;
  const int n = ntaps[fa][own];
  int fo[kTaps];
  float fw[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    const float2 e = taps[fa][own][j];
    fo[j] = j < n ? __float_as_int(e.x) * fstride : 0;
    fw[j] = j < n ? e.y : 0.0f;
  }
  using Raw = typename Vec<T, V>::Raw;
  // the contraction along the thread's axis at tap g of the walked axis:
  // sum over the thread's taps in ascending order, one FMA each; every load
  // issued before the first FMA
  auto contract = [&](float* dst, int g) {
    const T* p = fb + g * wstride;
    Raw q[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      if (j < n) q[j] = Vec<T, V>::fetch(p + fo[j]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[e] = 0.0f;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      if (j < n) {
        float a[V];
        Vec<T, V>::unpack(q[j], a);
#pragma unroll
        for (int e = 0; e < V; ++e) dst[e] = fmaf(fw[j], a[e], dst[e]);
      }
    }
  };

  float ta[V], tb[V];     // the contraction at walked taps xa and xb
  int xa = -1, xb = -1;
  bool b_newer = true;    // which of the two was computed last
  for (int cell = 0; cell < R; ++cell) {
    const int m = ntaps[wa][cell];
    float2 e[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) e[j] = taps[wa][cell][j];
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      if (j >= m) break;
      const int g = __float_as_int(e[j].x);
      const float wg = e[j].y;
      bool use_a;
      if (g == xa) {
        use_a = true;
      } else if (g == xb) {
        use_a = false;
      } else if (b_newer) {
        contract(ta, g);
        xa = g;
        b_newer = false;
        use_a = true;
      } else {
        contract(tb, g);
        xb = g;
        b_newer = true;
        use_a = false;
      }
      if (use_a) {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(wg, ta[i], acc[i]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(wg, tb[i], acc[i]);
      }
    }
    Vec<T, V>::store(ob + (long long)cell * ostride, acc);
  }
}

template <typename T, int V, int S, int kRows>
int launch_s(const void* feats, const void* rois, void* out, int H, int W,
             int C, int total_rois, int rois_per_image, float spatial_scale,
             int res, cudaStream_t s) {
  dim3 grid((unsigned)total_rois, (unsigned)((C + kNV * V - 1) / (kNV * V)));
  roi_align_fwd_kernel<T, V, S, kRows><<<grid, res * kNV, 0, s>>>(
      (const T*)feats, (const float*)rois, (T*)out, H, W, C, rois_per_image,
      spatial_scale, res);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch(const void* feats, const void* rois, void* out, int H, int W,
           int C, int total_rois, int rois_per_image, float spatial_scale,
           int res, int sampling, cudaStream_t s) {
  // res * sampling <= 32: past 14 rows the sampling ratio is 1 or 2
  auto run = res > kFewRows ? (sampling == 1 ? &launch_s<T, V, 1, kMaxRes>
                                             : &launch_s<T, V, 2, kMaxRes>)
           : sampling == 1  ? &launch_s<T, V, 1, kFewRows>
           : sampling == 2  ? &launch_s<T, V, 2, kFewRows>
           : sampling == 3  ? &launch_s<T, V, 3, kFewRows>
                            : &launch_s<T, V, 4, kFewRows>;
  return run(feats, rois, out, H, W, C, total_rois, rois_per_image,
             spatial_scale, res, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. rois: (total_rois, 4) float32, image
// b owns rows [b * rois_per_image, (b + 1) * rois_per_image). res *
// sampling <= 32, sampling <= 4, and one image's map holds fewer than
// 2**31 values. Returns the CUDA error code of the launch (0 on success).
extern "C" int coin_roi_align_fwd(const void* feats, const void* rois,
                                  void* out, int H, int W, int C,
                                  int total_rois, int rois_per_image,
                                  float spatial_scale, int res, int sampling,
                                  int dtype, void* stream) {
  if (res <= 0 || sampling <= 0 || sampling > kMaxS ||
      res * sampling > kMaxRes || total_rois <= 0 || H <= 0 || W <= 0 ||
      C <= 0 || (long long)H * W * C >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = (((uintptr_t)feats | (uintptr_t)out) % 16) == 0;
  if (dtype == 0) {
    auto run = aligned && C % 4 == 0 ? &launch<float, 4> : &launch<float, 1>;
    return run(feats, rois, out, H, W, C, total_rois, rois_per_image,
               spatial_scale, res, sampling, s);
  }
  if (dtype == 1) {
    auto run = aligned && C % 8 == 0 ? &launch<__nv_bfloat16, 8>
                                     : &launch<__nv_bfloat16, 1>;
    return run(feats, rois, out, H, W, C, total_rois, rois_per_image,
               spatial_scale, res, sampling, s);
  }
  return (int)cudaErrorInvalidValue;
}
