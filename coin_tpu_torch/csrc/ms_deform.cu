// K7 · multi-scale deformable sampling for Hopper (forward only).
//
// Replaces: coin_tpu/models/deformable.py `ms_deform_sample`, which the
// JAX package writes as four `take_along_axis` gathers per level over the
// flattened multi-level values plus tent weights, because the TPU has no
// fast scattered gather.
//
// Input: values (B, ΣHW, heads, D) bf16 or f32, D a multiple of 8 and
// 16-byte aligned; locations (B, Q, heads, L, P, 2) f32, (x, y) in [0, 1]
// per level (points outside sample zeros), 8-byte aligned; weights
// (B, Q, heads, L, P) f32; level shapes (L, 2) = (h, w) and level starts
// (L,) int32 on the device. Output (B, Q, heads, D) in the values' dtype.
//
// Computes, per (query, head, level, point), in JAX's order
// (deformable.py:35-61): x = loc.x * w - 0.5, floor, fractions, the four
// taps' weights (1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy·fx, each zeroed where
// its tap lies outside the level (the test on the float coordinates), the
// taps summed in the order 00, 01, 10, 11, then Σ_point tap_sum · weight
// per level in point order, then Σ_level. JAX rounds every tap and sum to
// the values' dtype; this kernel computes in f32 and rounds once.
// Explicitly rounded intrinsics keep nvcc from contracting a + b·c into
// an FMA, so in f32 the kernel repeats the plain version's rounding, and
// on bf16 values it is the plain version run in f32, rounded once.
//
// Bound: at the encoder's shape (4 x 15 352 queries, 8 heads, 4 levels x
// 4 points, D = 32) the function reads 31 MB of bf16 values, 63 MB of
// locations and 31 MB of weights and writes 31 MB: about 0.047 ms at
// 3.35 TB/s, against about 3 GFLOP. Its gather reads 4 taps of 64 bytes
// per point, 2.0 GB a launch through L1 out of the L2 that holds the
// values; but its time does not move with where the points fall (spread
// over the levels, around each query, or all in L1: tools/kernel_turns),
// so its instructions set its pace. Design: a thread per (batch, query,
// head, 8 channels), as
// before, so each thread sums its channels over the points in the plain
// version's order and nothing is exchanged after the taps; what the
// redesign removes is the work around the taps. At GDINO's shape (L = 4,
// P = 4, D = 32: 4 threads a row, every loop unrolled) the row's thread g
// computes the taps of level g's 4 points once, from one coalesced load
// of their 32 location floats and 4 weights, and hands them to the row's
// other threads by shuffles, where each thread used to compute all 16
// points itself from scalar loads and to reload the level's shape and
// start for each; and each thread issues the 16 tap loads of a level (f32:
// 8) before it adds any. Other shapes run a kernel that computes every
// point's taps itself, in the same order. A block takes neighbouring
// (query, head) rows, heads fastest; blocks of neighbouring queries of one
// head, whose points share more taps, ran slower (tools/kernel_turns).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                  // channels a thread

// 8 channels of a value row as f32: one 16-byte load of bf16, two of f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, uint4 (&r)[2]) {
  r[0] = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load8(const float* p, uint4 (&r)[2]) {
  r[0] = __ldg(reinterpret_cast<const uint4*>(p));
  r[1] = __ldg(reinterpret_cast<const uint4*>(p) + 1);
}
template <typename T>
__device__ __forceinline__ float chan(const uint4 (&r)[2], int c) {
  if constexpr (sizeof(T) == 2) {
    const unsigned u = (c >> 1) == 0 ? r[0].x : (c >> 1) == 1 ? r[0].y
                       : (c >> 1) == 2 ? r[0].z : r[0].w;
    return __uint_as_float((c & 1) ? (u & 0xffff0000u) : (u << 16));
  } else {
    const uint4& q = r[c >> 2];
    const int k = c & 3;
    return __uint_as_float(k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w);
  }
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

// The four taps of one point: pixel index within the batch's values and
// tap weight (0 outside the level), in the order 00, 01, 10, 11.
struct Taps {
  int pix[4];
  float w[4];
};

__device__ __forceinline__ Taps point_taps(float lx, float ly, int lh, int lw,
                                           int start) {
  Taps t;
  const float fh = (float)lh, fw = (float)lw;
  const float x = __fsub_rn(__fmul_rn(lx, fw), 0.5f);
  const float y = __fsub_rn(__fmul_rn(ly, fh), 0.5f);
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
  const float wy[2] = {__fsub_rn(1.0f, fy), fy};
  const float wx[2] = {__fsub_rn(1.0f, fx), fx};
  const float ty[2] = {y0, __fadd_rn(y0, 1.0f)};
  const float tx[2] = {x0, __fadd_rn(x0, 1.0f)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float yy = ty[k >> 1], xx = tx[k & 1];
    const bool inside = yy >= 0.0f && yy < fh && xx >= 0.0f && xx < fw;
    const int iy = (int)fminf(fmaxf(yy, 0.0f), fh - 1.0f);
    const int ix = (int)fminf(fmaxf(xx, 0.0f), fw - 1.0f);
    t.pix[k] = start + iy * lw + ix;
    t.w[k] = inside ? __fmul_rn(wy[k >> 1], wx[k & 1]) : 0.0f;
  }
  return t;
}

// lvl += (((v00 w00 + v01 w01) + v10 w10) + v11 w11) * a, channel by
// channel, every step rounded: the plain version's order.
template <typename T>
__device__ __forceinline__ void add_point(float* lvl, const uint4 (&r)[4][2],
                                          const float* w, float a) {
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    float s = __fmul_rn(chan<T>(r[0], c), w[0]);
    s = __fadd_rn(s, __fmul_rn(chan<T>(r[1], c), w[1]));
    s = __fadd_rn(s, __fmul_rn(chan<T>(r[2], c), w[2]));
    s = __fadd_rn(s, __fmul_rn(chan<T>(r[3], c), w[3]));
    lvl[c] = __fadd_rn(lvl[c], __fmul_rn(s, a));
  }
}

// The (batch * Q + query) * H + head row of a block's local row j, or -1
// past the last.
__device__ __forceinline__ long long row_of(int j, int rows_per_block, int B,
                                            int Q, int H) {
  const long long row = (long long)blockIdx.x * rows_per_block + j;
  return row < (long long)B * Q * H ? row : -1;
}

// GDINO's shape: L = 4 levels of P = 4 points, D = 32 channels, so a row
// takes 4 threads of 8 channels. Thread g of a row computes the taps of
// level g's points (one coalesced load of its 32 location floats and 4
// weights) and hands them to the row's other threads by shuffles; each
// thread then loads the 16 taps of a level (bf16; f32 two points at a
// time) before it adds them, in the plain version's order.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ms_deform_gdino_kernel(const T* __restrict__ values,
                       const float* __restrict__ loc,
                       const float* __restrict__ attw,
                       const int* __restrict__ shapes,
                       const int* __restrict__ starts, T* __restrict__ out,
                       int B, int S, int Q, int H) {
  constexpr int L = 4, P = 4, G = 4, D = 32;
  constexpr int kBatch = sizeof(T) == 2 ? 4 : 2;     // points in flight
  const int g = threadIdx.x % G;
  const long long row = row_of(threadIdx.x / G, kThreads / G, B, Q, H);
  const bool active = row >= 0;
  const long long r = active ? row : 0;
  const int h = (int)(r % H), b = (int)(r / ((long long)Q * H));
  // level g's points
  const float4* lp = reinterpret_cast<const float4*>(loc + r * L * P * 2);
  float4 xy[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                  make_float4(0.f, 0.f, 0.f, 0.f)};
  float4 a4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active) {
    xy[0] = __ldg(lp + 2 * g);
    xy[1] = __ldg(lp + 2 * g + 1);
    a4 = __ldg(reinterpret_cast<const float4*>(attw + r * L * P) + g);
  }
  const int lh = __ldg(shapes + 2 * g), lw = __ldg(shapes + 2 * g + 1);
  const int start = __ldg(starts + g);
  const Taps mine[P] = {point_taps(xy[0].x, xy[0].y, lh, lw, start),
                        point_taps(xy[0].z, xy[0].w, lh, lw, start),
                        point_taps(xy[1].x, xy[1].y, lh, lw, start),
                        point_taps(xy[1].z, xy[1].w, lh, lw, start)};
  const float ma[P] = {a4.x, a4.y, a4.z, a4.w};
  const size_t stride = (size_t)H * D;
  const T* vb = values + (size_t)b * S * stride + (size_t)h * D + g * kVec;
  float acc[kVec], lvl[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int c = 0; c < kVec; ++c) lvl[c] = 0.0f;
#pragma unroll
    for (int p0 = 0; p0 < P; p0 += kBatch) {
      Taps t[kBatch];
      float a[kBatch];
      uint4 raw[kBatch][4][2];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          t[i].pix[k] = __shfl_sync(0xffffffffu, mine[p0 + i].pix[k], l, G);
          t[i].w[k] = __shfl_sync(0xffffffffu, mine[p0 + i].w[k], l, G);
        }
        a[i] = __shfl_sync(0xffffffffu, ma[p0 + i], l, G);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          raw[i][k][0] = raw[i][k][1] = make_uint4(0u, 0u, 0u, 0u);
          if (active) load8(vb + (size_t)t[i].pix[k] * stride, raw[i][k]);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) add_point<T>(lvl, raw[i], t[i].w, a[i]);
    }
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[c] = __fadd_rn(acc[c], lvl[c]);
  }
  if (active) store8(out + r * D + g * kVec, acc);
}

// Any other shape: a thread per (row, 8 channels) computes every point's
// taps itself, in the same order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ms_deform_kernel(const T* __restrict__ values, const float* __restrict__ loc,
                 const float* __restrict__ attw,
                 const int* __restrict__ shapes,
                 const int* __restrict__ starts, T* __restrict__ out, int B,
                 int S, int Q, int H, int L, int P, int D) {
  const int G = D / kVec;
  const int rows_per_block = kThreads / G;
  if ((int)threadIdx.x >= rows_per_block * G) return;
  const int g = threadIdx.x % G;
  const long long row = row_of(threadIdx.x / G, rows_per_block, B, Q, H);
  if (row < 0) return;
  const int h = (int)(row % H), b = (int)(row / ((long long)Q * H));
  const float* lp = loc + row * L * P * 2;
  const float* wp = attw + row * L * P;
  const size_t stride = (size_t)H * D;
  const T* vb = values + (size_t)b * S * stride + (size_t)h * D + g * kVec;
  float acc[kVec], lvl[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) acc[c] = 0.0f;
  for (int l = 0; l < L; ++l) {
    const int lh = __ldg(shapes + 2 * l), lw = __ldg(shapes + 2 * l + 1);
    const int start = __ldg(starts + l);
#pragma unroll
    for (int c = 0; c < kVec; ++c) lvl[c] = 0.0f;
    for (int p = 0; p < P; ++p) {
      const int s = l * P + p;
      const Taps t = point_taps(__ldg(lp + 2 * s), __ldg(lp + 2 * s + 1), lh,
                                lw, start);
      uint4 raw[1][4][2];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        load8(vb + (size_t)t.pix[k] * stride, raw[0][k]);
      }
      add_point<T>(lvl, raw[0], t.w, __ldg(wp + s));
    }
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[c] = __fadd_rn(acc[c], lvl[c]);
  }
  store8(out + row * D + g * kVec, acc);
}

template <typename T>
int launch(const void* values, const void* loc, const void* attw,
           const void* shapes, const void* starts, void* out, int B, int S,
           int Q, int H, int L, int P, int D, cudaStream_t stream) {
  const int rows_per_block = kThreads / (D / kVec);
  if (rows_per_block < 1) return (int)cudaErrorInvalidValue;
  const long long blocks =
      ((long long)B * Q * H + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (L == 4 && P == 4 && D == 32) {       // GDINO's deformable attention
    ms_deform_gdino_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)values, (const float*)loc, (const float*)attw,
        (const int*)shapes, (const int*)starts, (T*)out, B, S, Q, H);
  } else {
    ms_deform_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)values, (const float*)loc, (const float*)attw,
        (const int*)shapes, (const int*)starts, (T*)out, B, S, Q, H, L, P, D);
  }
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
      D % kVec || D > kVec * kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return dtype ? launch<__nv_bfloat16>(values, loc, attw, shapes, starts, out,
                                       B, S, Q, H, L, P, D, s)
               : launch<float>(values, loc, attw, shapes, starts, out, B, S,
                               Q, H, L, P, D, s);
}
