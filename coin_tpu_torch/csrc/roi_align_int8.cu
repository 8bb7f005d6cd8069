// K5 · int8 RoIAlign forward (aligned=True, static sampling ratio) for
// Hopper: TPU.INT8_ROI's RoIAlign.
//
// Replaces: coin_tpu/ops/roi_align.py `roi_align_int8` (:188) with its parts
// `_quant_feat`, `_quant_interp`, `_requant_tmp` and `_roi_align_int8_value`,
// which the JAX package writes as two dense s8 interpolation-matrix
// contractions on the TPU's int8 MXU, with the (N, short, R, C) s32
// intermediate requantised to s8 between them.
//
// Semantics, each step one correctly rounded f32 operation in the source's
// order (no FMA contraction): the features are quantised per channel and
// image, s_f = max(max|f|, 1e-12) / 127, q = clip(rint(f / s_f), +-127); the
// interpolation matrices are K1's (coordinates as csrc/roi_align.cu builds
// them, the s samples' tents summed per grid line and divided by s) times
// 127, rounded to s8. When w >= h the W axis is contracted first:
// t[h, s] = sum_w ax_q[s, w] q[h, w]; t is requantised as
// clip(rint(f32(t) / 127), +-127); out[r, s] = sum_h ay_q[r, h] t_q[h, s];
// else H first and W second. The result is f32(out) * (s_f / 127), cast to
// the features' dtype. All sums are exact integers, so the kernel equals
// its plain version (ops/roi_align.roi_align_int8_plain) bit for bit.
//
// Bound: bytes. At the training shapes (3 images x 576 rois, 38 x 76 res4,
// 14 x 14, 1024 channels, bf16) the kernel must read the 17.7 MB map and
// write the 693.6 MB output once: 0.21 ms at 3.35 TB/s. Design: three
// launches. (1) The per-channel abs-max of each image's map, pixels split
// over blocks, combined with an integer atomicMax on the float bits (|f| is
// non-negative; a NaN's bits win, as JAX's max keeps a NaN). (2) The s8 map
// and the scales (B, C). (3) One block per (roi, output row r): the s8 tap
// lists of row r and of every output column are built once in shared
// memory (at most 2 s grid lines per cell, zero weights dropped); threads
// run along the channels, 8 per thread (one 8-byte s8 load, one 16-byte
// bf16 store). Each output cell sums its <= 4 x 4 taps in s32 registers and
// requantises the first contraction per tap of the second, so the dense
// (N, H, 14, C) s32 tensor of the JAX form (1.25 GB per image at these
// shapes) is never formed; the s8 map (8.9 MB) stays in L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxRes = 32;       // resolution <= kMaxRes
constexpr int kMaxSampling = 4;
constexpr int kMaxTaps = 2 * kMaxSampling;
constexpr int kThreads = 256;

// The non-zero entries of one row of an interpolation matrix: the grid
// lines that one output cell's s samples touch, with the mean of their
// tents (f32) and that mean on the s8 grid (rint(127 * w)).
struct Cell {
  int n;
  int idx[kMaxTaps];
  int q[kMaxTaps];
  float w[kMaxTaps];
};

__device__ void build_cell(float start, float bin, int j, int sampling,
                           int size, Cell* cell) {
  int n = 0;
  float sum[kMaxTaps];
  int idx[kMaxTaps];
  for (int k = 0; k < sampling; ++k) {
    const float off = __fdiv_rn((float)k + 0.5f, (float)sampling);
    const float pos =
        __fadd_rn(start, __fmul_rn(__fadd_rn((float)j, off), bin));
    if (!(pos >= -1.0f && pos <= (float)size)) continue;
    const float pc = fminf(fmaxf(pos, 0.0f), (float)(size - 1));
    const int lo = (int)floorf(pc);
    const int hi = min(lo + 1, size - 1);
    for (int g = lo; g <= hi; ++g) {
      const float t =
          fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pc, (float)g))));
      int i = 0;
      while (i < n && idx[i] != g) ++i;
      if (i == n) {
        idx[n] = g;
        sum[n] = 0.0f;
        ++n;
      }
      sum[i] = __fadd_rn(sum[i], t);
    }
  }
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const float w = __fdiv_rn(sum[i], (float)sampling);
    const int q = (int)rintf(__fmul_rn(w, 127.0f));
    if (w == 0.0f) continue;
    cell->idx[m] = idx[i];
    cell->w[m] = w;
    cell->q[m] = q;
    ++m;
  }
  cell->n = m;
}

__device__ __forceinline__ int requant(int t) {
  const float x = rintf(__fdiv_rn((float)t, 127.0f));
  return (int)fminf(fmaxf(x, -127.0f), 127.0f);
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// (1) amax[b, c] = max over the map of |f[b, :, :, c]|, as float bits
template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ feats, int* __restrict__ amax, int P,
              int C, int per_split) {
  const int b = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int p0 = blockIdx.z * per_split;
  const int p1 = min(P, p0 + per_split);
  const T* f = feats + (size_t)b * P * C + c;
  int m = 0;
  for (int p = p0; p < p1; ++p) {
    m = max(m, __float_as_int(fabsf(to_f32(f[(size_t)p * C]))));
  }
  atomicMax(amax + (size_t)b * C + c, m);
}

__device__ __forceinline__ float scale_of(int amax_bits) {
  const float a = __int_as_float(amax_bits);
  const float m = (a != a || a > 1e-12f) ? a : 1e-12f;
  return __fdiv_rn(m, 127.0f);
}

// (2) q = clip(rint(f / s_f), +-127) as s8 (NaN as 0); s_f per (b, c)
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ feats, const int* __restrict__ amax,
                int8_t* __restrict__ q, float* __restrict__ sf, int P, int C,
                long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  const int b = (int)(i / ((long long)P * C));
  const float s = scale_of(amax[(size_t)b * C + c]);
  const float x = rintf(__fdiv_rn(to_f32(feats[i]), s));
  // a NaN (a NaN feature, or a channel whose scale is NaN) becomes 0
  q[i] = x != x ? (int8_t)0 : (int8_t)(int)fminf(fmaxf(x, -127.0f), 127.0f);
  if ((i / C) % P == 0) sf[(size_t)b * C + c] = s;
}

// V s8 channels of one pixel as one load
template <int V> struct S8;
template <> struct S8<1> {
  static __device__ __forceinline__ void load(const int8_t* p, int* v) {
    v[0] = p[0];
  }
};
template <> struct S8<8> {
  static __device__ __forceinline__ void load(const int8_t* p, int* v) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = (int)(int8_t)((u.x >> (8 * i)) & 0xff);
      v[4 + i] = (int)(int8_t)((u.y >> (8 * i)) & 0xff);
    }
  }
};

template <typename T, int V> struct Store;
template <typename T> struct Store<T, 1> {
  static __device__ __forceinline__ void run(T* p, const float* v) {
    p[0] = from_f32<T>(v[0]);
  }
};
template <> struct Store<float, 8> {
  static __device__ __forceinline__ void run(float* p, const float* v) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};
template <> struct Store<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void run(__nv_bfloat16* p,
                                             const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// (3) one block per (roi, output row r)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
roi_align_int8_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ sf,
                      const float* __restrict__ rois, T* __restrict__ out,
                      int H, int W, int C, int rois_per_image,
                      float spatial_scale, int res, int sampling) {
  const int roi = blockIdx.x;
  const int r = blockIdx.y;
  const int b = roi / rois_per_image;
  __shared__ Cell xcell[kMaxRes];
  __shared__ Cell ycell;
  const float* box = rois + 4 * (size_t)roi;
  const float x1 = __fsub_rn(__fmul_rn(box[0], spatial_scale), 0.5f);
  const float y1 = __fsub_rn(__fmul_rn(box[1], spatial_scale), 0.5f);
  const float x2 = __fsub_rn(__fmul_rn(box[2], spatial_scale), 0.5f);
  const float y2 = __fsub_rn(__fmul_rn(box[3], spatial_scale), 0.5f);
  const float bin_w = __fdiv_rn(__fsub_rn(x2, x1), (float)res);
  const float bin_h = __fdiv_rn(__fsub_rn(y2, y1), (float)res);
  for (int s = threadIdx.x; s < res; s += blockDim.x) {
    build_cell(x1, bin_w, s, sampling, W, &xcell[s]);
  }
  if (threadIdx.x == blockDim.x - 1) {
    build_cell(y1, bin_h, r, sampling, H, &ycell);
  }
  __syncthreads();

  const bool w_first = W >= H;
  const int8_t* qb = q + (size_t)b * H * W * C;
  const float* sfb = sf + (size_t)b * C;
  T* ob = out + (((size_t)roi * res + r) * res) * C;
  const int ny = ycell.n;
  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    float scale[V];
#pragma unroll
    for (int v = 0; v < V; ++v) scale[v] = __fdiv_rn(sfb[c + v], 127.0f);
    for (int s = 0; s < res; ++s) {
      const int nx = xcell[s].n;
      int acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0;
      // outer: the axis contracted second; inner: the one contracted first
      const int no = w_first ? ny : nx;
      const int ni = w_first ? nx : ny;
      for (int o = 0; o < no; ++o) {
        const int qo = w_first ? ycell.q[o] : xcell[s].q[o];
        const int io = w_first ? ycell.idx[o] : xcell[s].idx[o];
        int t[V];
#pragma unroll
        for (int v = 0; v < V; ++v) t[v] = 0;
        for (int i = 0; i < ni; ++i) {
          const int qi = w_first ? xcell[s].q[i] : ycell.q[i];
          const int ii = w_first ? xcell[s].idx[i] : ycell.idx[i];
          const int h = w_first ? io : ii;
          const int w = w_first ? ii : io;
          int f[V];
          S8<V>::load(qb + ((size_t)h * W + w) * C + c, f);
#pragma unroll
          for (int v = 0; v < V; ++v) t[v] += qi * f[v];
        }
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] += qo * requant(t[v]);
      }
      float o32[V];
#pragma unroll
      for (int v = 0; v < V; ++v) o32[v] = __fmul_rn((float)acc[v], scale[v]);
      Store<T, V>::run(ob + (size_t)s * C + c, o32);
    }
  }
}

template <typename T>
int launch(const void* feats, const void* rois, void* out, void* amax,
           void* q, void* sf, int B, int H, int W, int C, int total_rois,
           int rois_per_image, float spatial_scale, int res, int sampling,
           cudaStream_t stream) {
  const int P = H * W;
  const int cblocks = (C + kThreads - 1) / kThreads;
  int splits = (2 * 132 + B * cblocks - 1) / (B * cblocks);
  splits = std::max(1, std::min(splits, (P + 63) / 64));
  const int per_split = (P + splits - 1) / splits;
  absmax_kernel<T><<<dim3(B, cblocks, splits), kThreads, 0, stream>>>(
      (const T*)feats, (int*)amax, P, C, per_split);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long total = (long long)B * P * C;
  quantize_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(
      (const T*)feats, (const int*)amax, (int8_t*)q, (float*)sf, P, C, total);
  err = (int)cudaGetLastError();
  if (err) return err;
  dim3 grid(total_rois, res);
  const bool vec = C % 8 == 0 && ((uintptr_t)out % 16) == 0;
  const int lanes = vec ? C / 8 : C;
  const int threads = std::min(kThreads, ((lanes + 31) / 32) * 32);
  if (vec) {
    roi_align_int8_kernel<T, 8><<<grid, threads, 0, stream>>>(
        (const int8_t*)q, (const float*)sf, (const float*)rois, (T*)out, H,
        W, C, rois_per_image, spatial_scale, res, sampling);
  } else {
    roi_align_int8_kernel<T, 1><<<grid, threads, 0, stream>>>(
        (const int8_t*)q, (const float*)sf, (const float*)rois, (T*)out, H,
        W, C, rois_per_image, spatial_scale, res, sampling);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// feats (B, H, W, C) NHWC, dtype 0 = float32, 1 = bfloat16; rois
// (total_rois, 4) float32, image b owning rows [b * rois_per_image,
// (b + 1) * rois_per_image); out (total_rois, res, res, C) in the features'
// dtype. Scratch from the caller: amax (B, C) int32 zeroed, q (B, H, W, C)
// int8, sf (B, C) float32. Returns the CUDA error code of the launches.
extern "C" int coin_roi_align_int8_fwd(const void* feats, const void* rois,
                                       void* out, void* amax, void* q,
                                       void* sf, int B, int H, int W, int C,
                                       int total_rois, int rois_per_image,
                                       float spatial_scale, int res,
                                       int sampling, int dtype,
                                       void* stream) {
  if (res > kMaxRes || sampling < 1 || sampling > kMaxSampling ||
      total_rois <= 0 || B <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch<float>(feats, rois, out, amax, q, sf, B, H, W, C,
                         total_rois, rois_per_image, spatial_scale, res,
                         sampling, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(feats, rois, out, amax, q, sf, B, H, W, C,
                                 total_rois, rois_per_image, spatial_scale,
                                 res, sampling, s);
  }
  return (int)cudaErrorInvalidValue;
}
