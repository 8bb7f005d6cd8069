// K5b · int8 RoIAlign backward for Hopper: the straight-through gradient of
// the features; the RoIs get none.
//
// Replaces: coin_tpu/ops/roi_align.py `_ra_int8_bwd` (:213-232), the exact
// bilinear transpose that the JAX package runs as two dense einsums on the
// TPU: with ax, ay (the unquantised interpolation matrices) and the incoming
// gradient g in the features' dtype,
//   t[n, h, s, c] = dtype(sum_r ay[n, r, h] g[n, r, s, c])   (f32 sums)
//   df[h, w, c]   = dtype(sum_{n, s} t[n, h, s, c] ax[n, s, w])   (f32)
// The rounding of t to the features' dtype is what sets this apart from
// K1b, which rounds once at the output.
//
// Bound: bytes. At the training shapes (3 images x 576 rois, 14 x 14, 1024
// channels, bf16) the kernel must read the 693.6 MB gradient and write the
// 17.7 MB feature gradient once: about 0.21 ms at 3.35 TB/s. Design: one
// block per (roi, feature row h); a block whose row no cell of the RoI
// touches exits at once. The matrices' non-zero entries of every output row
// and column are built in shared memory exactly as csrc/roi_align_int8.cu
// builds them (correctly rounded intrinsics in the JAX order), then rounded
// to the features' dtype. Threads run along the channels, 8 per thread: for
// each output column s the thread sums the rows r that touch h (exact
// products, f32 sum), rounds t, and adds t * ax into the f32 (B, H, W, C)
// buffer at the <= 2 s grid columns of s with 16-byte vector atomics
// (sm_90). The caller casts the buffer to the features' dtype. The f32 sums
// follow the atomics' order, so results vary in the last bits from run to
// run, and a t near a rounding boundary may round to the neighbouring
// value: the kernel is held to its plain version at a stated tolerance.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#if defined(__CUDACC_VER_MAJOR__) &&                                     \
    (__CUDACC_VER_MAJOR__ > 12 ||                                        \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 5))
#define COIN_VECTOR_ATOMICS 1
#endif

namespace {

constexpr int kMaxRes = 32;
constexpr int kMaxSampling = 4;
constexpr int kMaxTaps = 2 * kMaxSampling;
constexpr int kThreads = 256;

struct Cell {
  int n;
  int idx[kMaxTaps];
  float w[kMaxTaps];   // the mean of the samples' tents, in the dtype
};

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one row of an interpolation matrix, as csrc/roi_align_int8.cu builds it
template <typename T>
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
    const float w = round_to<T>(__fdiv_rn(sum[i], (float)sampling));
    if (w == 0.0f) continue;
    cell->idx[m] = idx[i];
    cell->w[m] = w;
    ++m;
  }
  cell->n = m;
}

template <typename T, int V> struct Load;
template <typename T> struct Load<T, 1> {
  static __device__ __forceinline__ void run(const T* p, float* v);
};
template <> __device__ __forceinline__ void Load<float, 1>::run(
    const float* p, float* v) {
  v[0] = *p;
}
template <> __device__ __forceinline__ void Load<__nv_bfloat16, 1>::run(
    const __nv_bfloat16* p, float* v) {
  v[0] = __bfloat162float(*p);
}
template <> struct Load<float, 8> {
  static __device__ __forceinline__ void run(const float* p, float* v) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
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

// dst[0:V] += w * t[0:V]; V is 1 or 8 (dst 16-byte aligned)
template <int V>
__device__ __forceinline__ void scatter(float* dst, float w, const float* t) {
  if constexpr (V == 1) {
    atomicAdd(dst, __fmul_rn(w, t[0]));
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
#ifdef COIN_VECTOR_ATOMICS
      atomicAdd(reinterpret_cast<float4*>(dst + i),
                make_float4(__fmul_rn(w, t[i]), __fmul_rn(w, t[i + 1]),
                            __fmul_rn(w, t[i + 2]), __fmul_rn(w, t[i + 3])));
#else
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        atomicAdd(dst + i + j, __fmul_rn(w, t[i + j]));
      }
#endif
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
roi_align_int8_bwd_kernel(const T* __restrict__ grad,
                          const float* __restrict__ rois,
                          float* __restrict__ dfeat, int H, int W, int C,
                          int rois_per_image, float spatial_scale, int res,
                          int sampling) {
  const int roi = blockIdx.x;
  const int h = blockIdx.y;
  const int b = roi / rois_per_image;
  __shared__ Cell xcell[kMaxRes];
  __shared__ Cell ycell[kMaxRes];
  __shared__ int rows[kMaxRes];     // the output rows r that touch h
  __shared__ float wrow[kMaxRes];   // and ay[r, h]
  __shared__ int nrows;
  const float* box = rois + 4 * (size_t)roi;
  const float x1 = __fsub_rn(__fmul_rn(box[0], spatial_scale), 0.5f);
  const float y1 = __fsub_rn(__fmul_rn(box[1], spatial_scale), 0.5f);
  const float x2 = __fsub_rn(__fmul_rn(box[2], spatial_scale), 0.5f);
  const float y2 = __fsub_rn(__fmul_rn(box[3], spatial_scale), 0.5f);
  const float bin_w = __fdiv_rn(__fsub_rn(x2, x1), (float)res);
  const float bin_h = __fdiv_rn(__fsub_rn(y2, y1), (float)res);
  for (int j = threadIdx.x; j < 2 * res; j += blockDim.x) {
    if (j < res) {
      build_cell<T>(x1, bin_w, j, sampling, W, &xcell[j]);
    } else {
      build_cell<T>(y1, bin_h, j - res, sampling, H, &ycell[j - res]);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int r = 0; r < res; ++r) {
      for (int i = 0; i < ycell[r].n; ++i) {
        if (ycell[r].idx[i] == h) {
          rows[n] = r;
          wrow[n] = ycell[r].w[i];
          ++n;
        }
      }
    }
    nrows = n;
  }
  __syncthreads();
  const int nr = nrows;
  if (nr == 0) return;

  const T* gb = grad + (size_t)roi * res * res * C;
  float* db = dfeat + ((size_t)b * H + h) * W * C;
  for (int c = threadIdx.x * V; c < C; c += blockDim.x * V) {
    for (int s = 0; s < res; ++s) {
      float t[V];
#pragma unroll
      for (int v = 0; v < V; ++v) t[v] = 0.0f;
      for (int k = 0; k < nr; ++k) {
        float g[V];
        Load<T, V>::run(gb + ((size_t)rows[k] * res + s) * C + c, g);
        const float wy = wrow[k];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          t[v] = __fadd_rn(t[v], __fmul_rn(wy, g[v]));
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) t[v] = round_to<T>(t[v]);
      const Cell& xc = xcell[s];
      for (int i = 0; i < xc.n; ++i) {
        scatter<V>(db + (size_t)xc.idx[i] * C + c, xc.w[i], t);
      }
    }
  }
}

template <typename T>
int launch(const void* grad, const void* rois, void* dfeat, int H, int W,
           int C, int total_rois, int rois_per_image, float spatial_scale,
           int res, int sampling, cudaStream_t stream) {
  dim3 grid(total_rois, H);
  const bool vec =
      C % 8 == 0 && (((uintptr_t)grad | (uintptr_t)dfeat) % 16) == 0;
  const int lanes = vec ? C / 8 : C;
  const int threads =
      std::min(kThreads, std::max(64, ((lanes + 31) / 32) * 32));
  if (vec) {
    roi_align_int8_bwd_kernel<T, 8><<<grid, threads, 0, stream>>>(
        (const T*)grad, (const float*)rois, (float*)dfeat, H, W, C,
        rois_per_image, spatial_scale, res, sampling);
  } else {
    roi_align_int8_bwd_kernel<T, 1><<<grid, threads, 0, stream>>>(
        (const T*)grad, (const float*)rois, (float*)dfeat, H, W, C,
        rois_per_image, spatial_scale, res, sampling);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// grad (total_rois, res, res, C) in the features' dtype (0 = float32, 1 =
// bfloat16); rois (total_rois, 4) float32, image b owning rows
// [b * rois_per_image, (b + 1) * rois_per_image); dfeat (B, H, W, C)
// float32, zeroed by the caller. Returns the CUDA error code of the launch.
extern "C" int coin_roi_align_int8_bwd(const void* grad, const void* rois,
                                       void* dfeat, int H, int W, int C,
                                       int total_rois, int rois_per_image,
                                       float spatial_scale, int res,
                                       int sampling, int dtype,
                                       void* stream) {
  if (res > kMaxRes || sampling < 1 || sampling > kMaxSampling ||
      total_rois <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch<float>(grad, rois, dfeat, H, W, C, total_rois,
                         rois_per_image, spatial_scale, res, sampling, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(grad, rois, dfeat, H, W, C, total_rois,
                                 rois_per_image, spatial_scale, res,
                                 sampling, s);
  }
  return (int)cudaErrorInvalidValue;
}
