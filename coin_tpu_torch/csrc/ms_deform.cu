// K7 · multi-scale deformable sampling for Hopper (forward only).
//
// Replaces: coin_tpu/models/deformable.py `ms_deform_sample`, which the
// JAX package writes as four `take_along_axis` gathers per level over the
// flattened multi-level values plus tent weights, because the TPU has no
// fast scattered gather.
//
// Input: values (B, ΣHW, heads, D) bf16 or f32, D a multiple of 8 and
// 16-byte aligned; locations (B, Q, heads, L, P, 2) f32, (x, y) in [0, 1]
// per level (points outside sample zeros); weights (B, Q, heads, L, P)
// f32; level shapes (L, 2) = (h, w) and level starts (L,) int32 on the
// device. Output (B, Q, heads, D) in the values' dtype.
//
// Computes, per (query, head, level, point), in JAX's order
// (deformable.py:35-61): x = loc.x * w - 0.5, floor, fractions, the four
// taps' weights (1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy·fx, each zeroed
// where its tap lies outside the level (the test on the float
// coordinates), the taps summed in the order 00, 01, 10, 11, then
// Σ_point tap_sum · weight per level, then Σ_level. JAX rounds every tap
// and sum to the values' dtype; this kernel accumulates in f32 and rounds
// once. Explicitly rounded intrinsics keep nvcc from contracting a + b·c
// into an FMA, so in f32 the kernel repeats the plain version's rounding.
//
// Bound: at the encoder's shape (4 x 15 352 queries, 8 heads, 4 levels x
// 4 points, D = 32) the function reads 31 MB of bf16 values, 63 MB of
// locations and 31 MB of weights and writes 31 MB: about 0.05 ms at
// 3.35 TB/s, against about 3 GFLOP. Design: one thread per (batch, query,
// head, 8 channels), so the four threads of one (query, head) read one
// 64-byte row of values per tap with 16-byte vector loads, and the
// sampled rows of neighbouring queries overlap in L2; the locations and
// weights are read once per thread group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                  // channels per thread

struct Vec8 {
  float v[kVec];
};

__device__ __forceinline__ Vec8 load8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return Vec8{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}
__device__ __forceinline__ Vec8 load8(const __nv_bfloat16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  Vec8 out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out.v[2 * i] = f.x;
    out.v[2 * i + 1] = f.y;
  }
  return out;
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ms_deform_kernel(const T* __restrict__ values, const float* __restrict__ loc,
                 const float* __restrict__ attw,
                 const int* __restrict__ shapes,
                 const int* __restrict__ starts, T* __restrict__ out,
                 long long total, int S, int Q, int H, int L, int P, int D) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int groups = D / kVec;
  const int g = (int)(t % groups);
  const long long bqh = t / groups;              // (b * Q + q) * H + h
  const int h = (int)(bqh % H);
  const int b = (int)(bqh / H / Q);
  const float* lp = loc + bqh * L * P * 2;
  const float* wp = attw + bqh * L * P;
  const T* vb = values + (size_t)b * S * H * D + (size_t)h * D + g * kVec;

  float acc[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) acc[c] = 0.0f;
  for (int l = 0; l < L; ++l) {
    const int lh = shapes[2 * l], lw = shapes[2 * l + 1];
    const int start = starts[l];
    const float fh = (float)lh, fw = (float)lw;
    float lvl[kVec];
#pragma unroll
    for (int c = 0; c < kVec; ++c) lvl[c] = 0.0f;
    for (int p = 0; p < P; ++p) {
      const float x = __fsub_rn(__fmul_rn(lp[(l * P + p) * 2], fw), 0.5f);
      const float y = __fsub_rn(__fmul_rn(lp[(l * P + p) * 2 + 1], fh), 0.5f);
      const float x0 = floorf(x), y0 = floorf(y);
      const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
      const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
      const float ty[2] = {y0, __fadd_rn(y0, 1.0f)};
      const float tx[2] = {x0, __fadd_rn(x0, 1.0f)};
      const float wy[2] = {gy, fy};
      const float wx[2] = {gx, fx};
      float sum[kVec];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float yy = ty[k >> 1], xx = tx[k & 1];
        const bool inside = yy >= 0.0f && yy < fh && xx >= 0.0f && xx < fw;
        const float wgt = inside ? __fmul_rn(wy[k >> 1], wx[k & 1]) : 0.0f;
        const int iy = (int)fminf(fmaxf(yy, 0.0f), fh - 1.0f);
        const int ix = (int)fminf(fmaxf(xx, 0.0f), fw - 1.0f);
        const Vec8 v = load8(vb + ((size_t)(start + iy * lw + ix) * H) * D);
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const float tap = __fmul_rn(v.v[c], wgt);
          sum[c] = k == 0 ? tap : __fadd_rn(sum[c], tap);
        }
      }
      const float a = wp[l * P + p];
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        lvl[c] = __fadd_rn(lvl[c], __fmul_rn(sum[c], a));
      }
    }
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[c] = __fadd_rn(acc[c], lvl[c]);
  }
  store8(out + bqh * D + g * kVec, acc);
}

template <typename T>
int launch(const void* values, const void* loc, const void* attw,
           const void* shapes, const void* starts, void* out, int B, int S,
           int Q, int H, int L, int P, int D, cudaStream_t stream) {
  const long long total = (long long)B * Q * H * (D / kVec);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  ms_deform_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)values, (const float*)loc, (const float*)attw,
      (const int*)shapes, (const int*)starts, (T*)out, total, S, Q, H, L, P,
      D);
  return (int)cudaGetLastError();
}

}  // namespace

// values: (B, S, H, D), dtype 0 = f32, 1 = bf16; loc: (B, Q, H, L, P, 2)
// f32; attw: (B, Q, H, L, P) f32; shapes: (L, 2) int32 (h, w); starts:
// (L,) int32; out: (B, Q, H, D) of the values' dtype. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int coin_ms_deform(const void* values, const void* loc,
                              const void* attw, const void* shapes,
                              const void* starts, void* out, int B, int S,
                              int Q, int H, int L, int P, int D, int dtype,
                              void* stream) {
  if (B <= 0 || Q <= 0 || H <= 0 || L <= 0 || P <= 0 || D <= 0 ||
      D % kVec) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return dtype ? launch<__nv_bfloat16>(values, loc, attw, shapes, starts, out,
                                       B, S, Q, H, L, P, D, s)
               : launch<float>(values, loc, attw, shapes, starts, out, B, S,
                               Q, H, L, P, D, s);
}
