// K9 · Swin (shifted) window attention for Hopper.
//
// Replaces: coin_tpu/models/swin.py `WindowAttention` (core :69-90), which
// the JAX package writes as batched einsums over every window at once so
// that XLA feeds the TPU's matrix unit large contractions.
//
// Input: the packed output of the `qkv` linear, (B·nW, n, 3, heads, d)
// in bf16 or f32 (n = window², d = 32 or 64); the relative-position bias
// table ((2w-1)², heads) f32 and its (n, n) index; optionally the shift
// mask (nW, n, n) f32 of 0 / -1e9, applied to window `bn % nW`. Output:
// (B·nW, n, heads·d) in the input's dtype, ready for the `proj` linear.
//
// Computes, per (window, head), in JAX's order: scores = q·kᵀ in f32,
// / sqrt(d), + bias[index], + mask; softmax in f32 (exp(x - max) / sum);
// the probabilities rounded to the input dtype (swin.py:88 casts them to
// bf16); out = p·v accumulated in f32 and rounded once.
//
// Bound: at Swin-B's shapes (n = 144, d = 32) a window-head does 2·n²·d
// multiply-adds on 3·n·d inputs, about 1.3 MFLOP on 28 KB of bf16: the
// scores never have to leave the SM, so the bound is the bytes of qkv
// read once and the output written once. Design: one block of 512
// threads per (window, head); q, k and v are read straight from the
// packed tensor with strides into shared memory as f32 (rows padded to
// d + 1 floats against bank conflicts), and the n × n scores stay in
// dynamic shared memory (83 KB at n = 144; 141 KB in all, so one block per
// SM). Each thread computes a 4 × 4 tile of scores (4 query rows and 4
// keys, strided so that a warp's lanes read different keys' banks), which
// loads 8 values from shared memory per 16 multiply-adds instead of 2 per
// one; one warp per row takes the softmax; for p·v each thread keeps 4
// rows of one channel, a warp reading one row of p by broadcast and
// neighbouring channels of v. Every dot product is one FMA chain in
// channel (or key) order. CUDA cores only; tensor cores (mma / wgmma) are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 4;                   // rows (and keys) per thread's tile
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// a probability rounded to the dtype of v, as `.astype(v.dtype)`
__device__ __forceinline__ float round_like(float v, const float*) {
  return v;
}
__device__ __forceinline__ float round_like(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

size_t smem_bytes(int n, int d, int table_rows) {
  return sizeof(float) * ((size_t)2 * n * (d + 1) + (size_t)n * d
                          + (size_t)n * n + table_rows);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ table,
                        const int* __restrict__ index,
                        const float* __restrict__ mask, T* __restrict__ out,
                        int n, int heads, int table_rows, int mask_windows,
                        float sqrt_d) {
  extern __shared__ float smem[];
  constexpr int kStride = D + 1;
  float* qs = smem;                       // n x (D + 1)
  float* ks = qs + n * kStride;           // n x (D + 1)
  float* vs = ks + n * kStride;           // n x D
  float* s = vs + n * D;                  // n x n scores, then probabilities
  float* tb = s + n * n;                  // this head's bias column
  const int bn = blockIdx.x, h = blockIdx.y;
  const int dim = heads * D;
  const T* base = qkv + (size_t)bn * n * 3 * dim + h * D;

  for (int t = threadIdx.x; t < n * D; t += kThreads) {
    const int i = t / D, c = t % D;
    const T* row = base + (size_t)i * 3 * dim + c;
    qs[i * kStride + c] = to_f(row[0]);
    ks[i * kStride + c] = to_f(row[dim]);
    vs[i * D + c] = to_f(row[2 * dim]);
  }
  for (int t = threadIdx.x; t < table_rows; t += kThreads) {
    tb[t] = table[(size_t)t * heads + h];
  }
  __syncthreads();

  // scores: each thread a tile of kR query rows x kR keys, strided by
  // `tiles` so that the lanes of a warp read different keys' banks; the
  // dot products run over the channels in order, as one FMA chain each
  const int tiles = (n + kR - 1) / kR;
  const float* mrow =
      mask == nullptr ? nullptr : mask + (size_t)(bn % mask_windows) * n * n;
  for (int t = threadIdx.x; t < tiles * tiles; t += kThreads) {
    const int ti = t / tiles, tj = t % tiles;
    const float* qr[kR];
    const float* kr[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      qr[r] = qs + min(ti + tiles * r, n - 1) * kStride;
      kr[r] = ks + min(tj + tiles * r, n - 1) * kStride;
    }
    float acc[kR][kR];
#pragma unroll
    for (int a = 0; a < kR; ++a) {
#pragma unroll
      for (int b = 0; b < kR; ++b) acc[a][b] = 0.0f;
    }
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[kR], kv[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        qv[r] = qr[r][c];
        kv[r] = kr[r][c];
      }
#pragma unroll
      for (int a = 0; a < kR; ++a) {
#pragma unroll
        for (int b = 0; b < kR; ++b) {
          acc[a][b] = __fmaf_rn(qv[a], kv[b], acc[a][b]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kR; ++a) {
      const int i = ti + tiles * a;
#pragma unroll
      for (int b = 0; b < kR; ++b) {
        const int j = tj + tiles * b;
        if (i < n && j < n) {
          const int e = i * n + j;
          float v = __fadd_rn(__fdiv_rn(acc[a][b], sqrt_d), tb[index[e]]);
          if (mrow != nullptr) v = __fadd_rn(v, mrow[e]);
          s[e] = v;
        }
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < n; i += kWarps) {
    float* r = s + i * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, r[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(__fsub_rn(r[j], m));
      r[j] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) {
      r[j] = round_like(__fdiv_rn(r[j], sum), qkv);
    }
  }
  __syncthreads();

  // out = p · v: each thread kR rows of one channel; a warp shares its
  // rows (broadcast reads of p) and reads neighbouring channels of v
  T* ob = out + (size_t)bn * n * dim + h * D;
  for (int t = threadIdx.x; t < tiles * D; t += kThreads) {
    const int ti = t / D, c = t % D;
    const float* pr[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) pr[r] = s + min(ti + tiles * r, n - 1) * n;
    float acc[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = 0.0f;
    for (int m = 0; m < n; ++m) {
      const float v = vs[m * D + c];
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = __fmaf_rn(pr[r][m], v, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = ti + tiles * r;
      if (i < n) store(ob + (size_t)i * dim + c, acc[r]);
    }
  }
}

template <typename T, int D>
int launch(const void* qkv, const void* table, const void* index,
           const void* mask, void* out, int bn, int n, int heads,
           int table_rows, int mask_windows, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, D, table_rows);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = window_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bn, heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)qkv, (const float*)table, (const int*)index,
      (const float*)mask, (T*)out, n, heads, table_rows, mask_windows,
      sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// qkv: (bn, n, 3, heads, d) contiguous, dtype 0 = f32, 1 = bf16; table:
// (table_rows, heads) f32; index: (n, n) int32; mask: (mask_windows, n, n)
// f32 or null; out: (bn, n, heads * d) of qkv's dtype. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int coin_window_attention(const void* qkv, const void* table,
                                     const void* index, const void* mask,
                                     void* out, int bn, int n, int heads,
                                     int d, int table_rows, int mask_windows,
                                     int dtype, void* stream) {
  if (bn <= 0 || n <= 0 || heads <= 0 || (mask && mask_windows <= 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (heads > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 32) {
    return dtype ? launch<__nv_bfloat16, 32>(qkv, table, index, mask, out, bn,
                                             n, heads, table_rows,
                                             mask_windows, s)
                 : launch<float, 32>(qkv, table, index, mask, out, bn, n,
                                     heads, table_rows, mask_windows, s);
  }
  if (d == 64) {
    return dtype ? launch<__nv_bfloat16, 64>(qkv, table, index, mask, out, bn,
                                             n, heads, table_rows,
                                             mask_windows, s)
                 : launch<float, 64>(qkv, table, index, mask, out, bn, n,
                                     heads, table_rows, mask_windows, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" long long coin_window_attention_smem(int n, int d,
                                                int table_rows) {
  return (long long)smem_bytes(n, d, table_rows);
}
