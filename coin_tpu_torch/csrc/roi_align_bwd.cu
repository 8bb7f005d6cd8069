// K1b · RoIAlign backward (aligned=True, static sampling ratio) for Hopper:
// the gradient of the features; the RoIs get none (proposals and sampled
// boxes are constants of the step).
//
// Replaces: the autodiff transpose of coin_tpu/ops/roi_align.py
// `roi_align`'s two interpolation-matrix einsums (:85-94), which XLA runs as
// two dense contractions on the TPU:
//   dfeat[b] += sum over the image's rois of  ay^T . G_roi . ax
// with ay (R, H) and ax (R, W) the RoI's row and column interpolation
// weights (each the mean of its s samples' bilinear taps) and G_roi its
// (R, R, C) incoming gradient.
//
// Bound: bytes. At the training shapes (3 images x 576 rois, 14x14, 1024
// channels, bf16) the kernel must read the 693 MB gradient once and write
// the 12 MB feature gradient once: about 0.21 ms at 3.35 TB/s.
//
// Design: a block per RoI and 256 channels, the separable form in shared
// memory, then one flush of the RoI's footprint. The first version ran a
// thread per (RoI, output cell, 8 channels) and sent one 16-byte atomic
// into L2 per distinct bilinear tap of each cell (196 cells x 4 to 16 taps
// per RoI), and those atomics, most of them on the same few pixels for a RoI
// a few feature pixels wide, kept it 20 times above its bound. Here:
// 1. R threads compute the row taps and R the column taps with
//    csrc/roi_taps.cuh, as K1 does (correctly rounded intrinsics in the JAX
//    order; samples outside [-1, size] weigh 0, the rest are clamped),
//    which give the footprint, the rectangle of feature pixels the RoI
//    touches, and the weights ay, ax over it, each with the range of cells
//    that reach each footprint row and column; once per block, for all its
//    channels;
// 2. the block walks its channels 32 at a time: the R x R x 32 gradient
//    tile of the next chunk streams into shared memory (cp.async, two
//    buffers) while the block works on the current one;
// 3. per band of footprint columns (8, or the least power of two that
//    holds a narrower footprint): T[r][x] = sum_s ax[s][x] G[r][s]
//    (along x, into shared memory), then D[y][x] = sum_r ay[r][y] T[r][x]
//    (along y), each sum over the cells that reach x or y only, in f32;
// 4. each D[y][x] of the footprint is added into the f32 (B, H, W, C)
//    buffer with one 16-byte vector atomic per 4 channels; rows and columns
//    that no sample reaches are skipped.
// So a RoI sends one atomic per footprint pixel and channel vector (about
// (extent + 2)^2, however large its cells) instead of one per cell and tap.
// The footprint is at most the map (H x W); the weights over it live in
// shared memory beside the tiles, so no RoI needs tiling beyond its column
// bands. The caller casts the buffer to the features' dtype; atomics from
// RoIs that overlap add in no fixed order, so results vary in the last bits
// from run to run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "roi_taps.cuh"

#if defined(__CUDACC_VER_MAJOR__) &&                                     \
    (__CUDACC_VER_MAJOR__ > 12 ||                                        \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 5))
#define COIN_VECTOR_ATOMICS 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSampling = 4;
constexpr int kMaxRes = 16;
constexpr int kCs = 32;          // channels of a block
constexpr int kQ = kCs / 4;      // float4 per pixel of a block
constexpr int kLQ = 3;           // log2(kQ)
constexpr int kXC = 8;           // footprint columns of a band
constexpr int kChunks = 8;       // chunks of kCs channels a block walks

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& g) {
  acc.x = fmaf(w, g.x, acc.x);
  acc.y = fmaf(w, g.y, acc.y);
  acc.z = fmaf(w, g.z, acc.z);
  acc.w = fmaf(w, g.w, acc.w);
}

// dst[0:valid] += v; a 16-byte vector atomic when all four are there
__device__ __forceinline__ void flush4(float* dst, const float4& v, int valid,
                                      bool vec) {
#ifdef COIN_VECTOR_ATOMICS
  if (vec) {
    atomicAdd(reinterpret_cast<float4*>(dst), v);
    return;
  }
#endif
  const float a[4] = {v.x, v.y, v.z, v.w};
  for (int j = 0; j < valid; ++j) atomicAdd(dst + j, a[j]);
}

// The R samples' taps along one axis of the RoI: thread `r` (< R) owns cell
// r and adds its s samples' weights (1/s each, the samples' mean) into
// column r of wt (footprint index, R cells), noting the cells that reach
// each footprint index in [lo, hi].
__device__ __forceinline__ void taps(float start, float bin, int r, int S,
                                     int size, int f0, int R, float* wt,
                                     int* lo, int* hi) {
  const float inv = 1.0f / (float)S;
  for (int k = 0; k < S; ++k) {
    const roi_taps::Tap t = roi_taps::sample_tap(start, bin, r, k, S, size);
    if (!t.in) continue;
    wt[(t.lo - f0) * R + r] += t.wlo * inv;
    wt[(t.hi - f0) * R + r] += t.whi * inv;
    atomicMin(lo + t.lo - f0, r);
    atomicMax(hi + t.lo - f0, r);
    atomicMin(lo + t.hi - f0, r);
    atomicMax(hi + t.hi - f0, r);
  }
}

// the footprint [f0, f1] along one axis: the taps of the in-range samples
__device__ __forceinline__ void extent(float start, float bin, int r, int S,
                                       int size, int* f) {
  int mn = INT_MAX, mx = -1;
  for (int k = 0; k < S; ++k) {
    const roi_taps::Tap t = roi_taps::sample_tap(start, bin, r, k, S, size);
    if (!t.in) continue;
    mn = min(mn, t.lo);
    mx = max(mx, t.hi);
  }
  if (mx >= 0) {
    atomicMin(f, mn);
    atomicMax(f + 1, mx);
  }
}

__device__ __forceinline__ float4 to_f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 to_f4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of channels [c0, c0 + kCs) of the RoI's R x R cells into
// Gs ([cell][kCs] of T); channels past C are zeros. VEC: 16-byte copies
// that land while the block works on the previous chunk.
template <typename T, bool VEC>
__device__ __forceinline__ void load_chunk(const T* g, int cells, int C,
                                           int c0, T* Gs) {
  constexpr int P = 16 / sizeof(T);  // values of a 16-byte piece
  constexpr int pieces = kCs / P;
  for (int idx = threadIdx.x; idx < cells * pieces; idx += kThreads) {
    const int cell = idx / pieces, c = (idx - cell * pieces) * P;
    T* dst = Gs + cell * kCs + c;
    const T* src = g + (long long)cell * C + c0 + c;
    if (VEC && c0 + c + P <= C) {
      cp_async16(dst, src);
    } else {
      for (int j = 0; j < P; ++j)
        dst[j] = c0 + c + j < C ? src[j] : T(0.0f);
    }
  }
  cp_async_commit();
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
roi_align_bwd_kernel(const T* __restrict__ grad,
                     const float* __restrict__ rois,
                     float* __restrict__ dfeat, int H, int W, int C,
                     int rois_per_image, float spatial_scale, int R,
                     int sampling) {
  extern __shared__ float4 smem4[];
  float4* Ts = smem4;                        // [R][kXC][kQ]
  T* Gs = reinterpret_cast<T*>(Ts + R * kXC * kQ);  // 2 x [R * R][kCs]
  float* ayt = reinterpret_cast<float*>(Gs + 2 * R * R * kCs);  // [H][R]
  float* axt = ayt + H * R;                                     // [W][R]
  int* rlo = reinterpret_cast<int*>(axt + W * R);
  int* rhi = rlo + H;
  int* slo = rhi + H;
  int* shi = slo + W;
  __shared__ int fp[4];  // footprint rows y0, y1 and columns x0, x1

  const int t = threadIdx.x;
  const long long roi = blockIdx.x;
  const int first = blockIdx.y * kChunks * kCs;
  const int chunks = min(kChunks, (C - first + kCs - 1) / kCs);
  const int b = (int)(roi / rois_per_image);
  const T* g = grad + roi * R * R * C;
  const roi_taps::Frame f =
      roi_taps::frame(rois + 4 * roi, spatial_scale, R);
  const float x1 = f.x1, y1 = f.y1, bin_w = f.bin_w, bin_h = f.bin_h;

  if (t == 0) {
    fp[0] = INT_MAX; fp[1] = -1; fp[2] = INT_MAX; fp[3] = -1;
  }
  __syncthreads();
  if (t < R) extent(y1, bin_h, t, sampling, H, fp);
  else if (t < 2 * R) extent(x1, bin_w, t - R, sampling, W, fp + 2);
  __syncthreads();
  const int y0 = fp[0], fy = fp[1] - fp[0] + 1;
  const int x0 = fp[2], fx = fp[3] - fp[2] + 1;
  if (fy <= 0 || fx <= 0) return;  // every sample off the map
  load_chunk<T, VEC>(g, R * R, C, first, Gs);
  for (int i = t; i < fy * R; i += kThreads) ayt[i] = 0.0f;
  for (int i = t; i < fx * R; i += kThreads) axt[i] = 0.0f;
  for (int i = t; i < fy; i += kThreads) { rlo[i] = R; rhi[i] = -1; }
  for (int i = t; i < fx; i += kThreads) { slo[i] = R; shi[i] = -1; }
  __syncthreads();
  if (t < R) taps(y1, bin_h, t, sampling, H, y0, R, ayt, rlo, rhi);
  else if (t < 2 * R) taps(x1, bin_w, t - R, sampling, W, x0, R, axt, slo, shi);

  // bands of 2**lw columns: the least power of two that holds the
  // footprint's width, at most kXC
  const int lw = 32 - __clz(min(fx, kXC) - 1);
  float* base = dfeat + (long long)b * H * W * C;
  for (int ci = 0; ci < chunks; ++ci) {
    const int c0 = first + ci * kCs;
    const T* G = Gs + (ci & 1) * R * R * kCs;
    if (ci + 1 < chunks) {
      load_chunk<T, VEC>(g, R * R, C, c0 + kCs,
                         Gs + ((ci + 1) & 1) * R * R * kCs);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int xc = 0; xc < fx; xc += 1 << lw) {
      // along x: T[r][xl] = sum over the cells s that reach column xc + xl
      for (int idx = t; idx < R * kQ << lw; idx += kThreads) {
        const int q = idx & (kQ - 1), xl = (idx / kQ) & ((1 << lw) - 1);
        const int r = idx >> (lw + kLQ), x = xc + xl;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (x < fx)
          for (int s = slo[x]; s <= shi[x]; ++s)
            fma4(acc, axt[x * R + s], to_f4(G + (r * R + s) * kCs + 4 * q));
        Ts[idx] = acc;
      }
      __syncthreads();
      // along y, then the flush: one vector atomic per pixel and 4 channels
      for (int idx = t; idx < fy * kQ << lw; idx += kThreads) {
        const int q = idx & (kQ - 1), xl = (idx / kQ) & ((1 << lw) - 1);
        const int y = idx >> (lw + kLQ), x = xc + xl, c = c0 + 4 * q;
        if (x >= fx || c >= C || slo[x] > shi[x] || rlo[y] > rhi[y]) continue;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int r = rlo[y]; r <= rhi[y]; ++r)
          fma4(acc, ayt[y * R + r], Ts[((r << lw) + xl) * kQ + q]);
        const int valid = min(4, C - c);
        flush4(base + ((long long)(y0 + y) * W + x0 + x) * C + c, acc, valid,
               VEC && valid == 4);
      }
      __syncthreads();
    }
  }
}

template <typename T>
size_t smem_bytes(int H, int W, int R) {
  return sizeof(float) * 4 * (size_t)R * kXC * kQ +
         sizeof(T) * 2 * (size_t)R * R * kCs +
         sizeof(float) * (size_t)(H + W) * R +
         sizeof(int) * 2 * (size_t)(H + W);
}

template <typename T, bool VEC>
int launch(const void* grad, const void* rois, void* dfeat, int H, int W,
           int C, int total_rois, int rois_per_image, float spatial_scale,
           int res, int sampling, cudaStream_t s) {
  auto kernel = roi_align_bwd_kernel<T, VEC>;
  const size_t smem = smem_bytes<T>(H, W, res);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)total_rois,
            (unsigned)((C + kChunks * kCs - 1) / (kChunks * kCs)));
  kernel<<<grid, kThreads, smem, s>>>(
      (const T*)grad, (const float*)rois, (float*)dfeat, H, W, C,
      rois_per_image, spatial_scale, res, sampling);
  return (int)cudaGetLastError();
}

}  // namespace

// grad: (total_rois, res, res, C) of dtype (0 = float32, 1 = bfloat16);
// rois: (total_rois, 4) float32, image b owning rows [b * rois_per_image,
// (b + 1) * rois_per_image); dfeat: a zeroed (B, H, W, C) float32 buffer
// that the kernel adds into. res <= 16, sampling <= 4, and the weights of an
// H x W map must fit in shared memory beside the tile. Returns the CUDA
// error code of the launch.
extern "C" int coin_roi_align_bwd(const void* grad, const void* rois,
                                  void* dfeat, int H, int W, int C,
                                  int total_rois, int rois_per_image,
                                  float spatial_scale, int res, int sampling,
                                  int dtype, void* stream) {
  if (total_rois <= 0 || res <= 0 || res > kMaxRes || sampling <= 0 ||
      sampling > kMaxSampling || H <= 0 || W <= 0 || C <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  // 16-byte copies of the gradient need C a multiple of 8 (bf16) or 4
  // (f32); the vector atomics need C a multiple of 4
  const bool aligned = (((uintptr_t)grad | (uintptr_t)dfeat) % 16) == 0;
  if (dtype == 0) {
    auto run = aligned && C % 4 == 0 ? &launch<float, true>
                                     : &launch<float, false>;
    return run(grad, rois, dfeat, H, W, C, total_rois, rois_per_image,
               spatial_scale, res, sampling, s);
  }
  if (dtype == 1) {
    auto run = aligned && C % 8 == 0 ? &launch<__nv_bfloat16, true>
                                     : &launch<__nv_bfloat16, false>;
    return run(grad, rois, dfeat, H, W, C, total_rois, rois_per_image,
               spatial_scale, res, sampling, s);
  }
  return (int)cudaErrorInvalidValue;
}
