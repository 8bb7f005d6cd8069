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
// interpolation matrices are K1's (coordinates as csrc/roi_taps.cuh builds
// them, the s samples' tents summed per grid line and divided by s) times
// 127, rounded to s8. When w >= h the W axis is contracted first:
// t[h, s] = sum_w ax_q[s, w] q[h, w]; t is requantised as
// clip(rint(f32(t) / 127), +-127); out[r, s] = sum_h ay_q[r, h] t_q[h, s];
// else H first and W second. The result is f32(out) * (s_f / 127), cast to
// the features' dtype. All sums are exact integers, so the kernel equals
// its plain version (ops/roi_align.roi_align_int8_plain) bit for bit.
//
// The requantisation is integer arithmetic: rint(f32(t) / 127) =
// sign(t) ((2 |t| + 127) div 254) for every |t| < 2**20 (the division is
// never a tie: 2t = 127 (2k + 1) has no integer solution), and |t| <= 129 x
// 127 here, since each row of ax_q sums to at most 129.
//
// Bound: bytes. At the training shapes (3 images x 576 rois, 38 x 76 res4,
// 14 x 14, 1024 channels, bf16) the kernel must read the 17.7 MB map and
// write the 693.6 MB output once: 0.21 ms at 3.35 TB/s. Design: three
// launches. (1) The per-channel abs-max of each image's map, pixels split
// over blocks, combined with an integer atomicMax on the float bits (|f| is
// non-negative; a NaN's bits win, as JAX's max keeps a NaN). (2) The s8 map
// and the scales (B, C): a thread per channel vector walks pixels, its
// scale divided once. (3) K1's plan (csrc/roi_align.cu): a block per RoI
// and 16 channel vectors (128 channels; 16 bytes of output a thread). 2R
// threads build each cell's s8 taps along both axes once, in shared memory
// (zero weights dropped). A thread owns one cell of the axis contracted
// first and a channel vector and walks the cells of the other axis in
// order; at each of a walked cell's taps (a footprint line) it needs the
// first contraction there, requantised, and keeps the last two in
// registers, so it computes and requantises each footprint line about once
// (the first design redid it for every output row: about 8 times on the
// trainer's RoIs) with every load issued before the first is used. With 8
// channels a thread, the first contraction is one dp4a per channel and 4
// taps: byte permutes gather channel e of the 4 taps' loads into one word
// (chip_smoke.py at 3 x 576 random RoIs, two runs: 0.5916 ms, where s32
// multiply-adds of unpacked values read 0.6258). Each output is an s32
// sum of the walked cell's taps times the held lines, rescaled once by the
// channel's s_f / 127 (kept in shared memory) and stored as 16-byte
// streaming stores. The dense (N, H, 14, C) s32 tensor of the JAX form
// (1.25 GB per image at these shapes) is never formed; the s8 map (8.9
// MB) stays in L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxRes = 32;       // resolution <= kMaxRes
constexpr int kMaxSampling = 4;
constexpr int kThreads = 256;     // the whole-map passes
constexpr int kNV = 16;           // channel vectors (threads) per cell
constexpr int kFewRows = 14;      // resolutions built for 4 blocks an SM

// One cell's taps along one axis: the grid lines its s samples touch, in
// ascending order, with the mean of their tents on the s8 grid
// (rint(127 w)); taps whose s8 weight is 0 add nothing and are dropped.
template <int S>
struct Cell {
  int n;
  int idx[2 * S];
  int q[2 * S];
};

template <int S>
__device__ void build_cell(float start, float bin, int j, int size,
                           Cell<S>* cell) {
  int n = 0;
  float sum[2 * S];
  int idx[2 * S];
  for (int k = 0; k < S; ++k) {
    const float off = __fdiv_rn((float)k + 0.5f, (float)S);
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
    const int q = (int)rintf(__fmul_rn(__fdiv_rn(sum[i], (float)S), 127.0f));
    if (q == 0) continue;
    cell->idx[m] = idx[i];
    cell->q[m] = q;
    ++m;
  }
  cell->n = m;
}

// clip(rint(f32(t) / 127), +-127) for |t| < 2**20, in integers
__device__ __forceinline__ int requant(int t) {
  const int r = min((2 * abs(t) + 127) / 254, 127);
  return t < 0 ? -r : r;
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// (1) amax[b, c] = max over the map of |f[b, :, :, c]|, as float bits
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_int8_absmax_kernel(const T* __restrict__ feats, int* __restrict__ amax,
                       int P, int C, int per_split) {
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

// V consecutive elements of one pixel as one access
template <typename T, int V> struct Load;
template <typename T> struct Load<T, 1> {
  static __device__ __forceinline__ void run(const T* p, float* v) {
    v[0] = to_f32(p[0]);
  }
};
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
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// V s8 values as one store
template <int V> struct StoreS8;
template <> struct StoreS8<1> {
  static __device__ __forceinline__ void run(int8_t* p, const int8_t* o) {
    p[0] = o[0];
  }
};
template <> struct StoreS8<8> {
  static __device__ __forceinline__ void run(int8_t* p, const int8_t* o) {
    uint2 u = make_uint2(0u, 0u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u.x |= (uint32_t)(uint8_t)o[i] << (8 * i);
      u.y |= (uint32_t)(uint8_t)o[4 + i] << (8 * i);
    }
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// (2) q = clip(rint(f / s_f), +-127) as s8 (NaN as 0); s_f per (b, c). A
// thread owns V channels of one image and walks a run of pixels.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
roi_int8_quant_kernel(const T* __restrict__ feats,
                      const int* __restrict__ amax, int8_t* __restrict__ q,
                      float* __restrict__ sf, int P, int C, int per_split) {
  const int b = blockIdx.z;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c >= C) return;
  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = scale_of(amax[(size_t)b * C + c + v]);
  if (blockIdx.x == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) sf[(size_t)b * C + c + v] = s[v];
  }
  const int p0 = blockIdx.x * per_split;
  const int p1 = min(P, p0 + per_split);
  const size_t base = (size_t)b * P * C + c;
  for (int p = p0; p < p1; ++p) {
    float f[V];
    Load<T, V>::run(feats + base + (size_t)p * C, f);
    int8_t o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      // zeros skip the division's slow path; a NaN becomes 0
      const float x = f[v] == 0.0f ? 0.0f : rintf(__fdiv_rn(f[v], s[v]));
      o[v] = x != x ? (int8_t)0
                    : (int8_t)(int)fminf(fmaxf(x, -127.0f), 127.0f);
    }
    StoreS8<V>::run(q + base + (size_t)p * C, o);
  }
}

// V s8 channels of one pixel: fetch issues the load, unpack widens it
template <int V> struct S8;
template <> struct S8<1> {
  using Raw = int8_t;
  static __device__ __forceinline__ Raw fetch(const int8_t* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void unpack(Raw r, int* v) { v[0] = r; }
};
template <> struct S8<8> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw fetch(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void unpack(Raw u, int* v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = (int)(int8_t)((u.x >> (8 * i)) & 0xff);
      v[4 + i] = (int)(int8_t)((u.y >> (8 * i)) & 0xff);
    }
  }
};

template <typename T, int V> struct Store;
template <> struct Store<float, 1> {
  static __device__ __forceinline__ void run(float* p, const float* v) {
    p[0] = v[0];
  }
};
template <> struct Store<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void run(__nv_bfloat16* p,
                                             const float* v) {
    p[0] = __float2bfloat16_rn(v[0]);
  }
};
template <> struct Store<float, 8> {
  static __device__ __forceinline__ void run(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1,
           make_float4(v[4], v[5], v[6], v[7]));
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
    __stcs(reinterpret_cast<uint4*>(p), u);
  }
};

// (3) a block per (roi, 16 channel vectors); kRows: the most output rows
// (resolution) a launch may have
template <typename T, int V, int S, int kRows>
__global__ void __launch_bounds__(kRows * kNV, kRows <= kFewRows ? 4 : 1)
roi_align_int8_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ sf,
                      const float* __restrict__ rois, T* __restrict__ out,
                      int H, int W, int C, int rois_per_image,
                      float spatial_scale, int R) {
  constexpr int kTaps = 2 * S;
  __shared__ Cell<S> cells[2][kRows];      // [axis: 0 x, 1 y][cell]
  __shared__ __align__(16) float scales[kNV * V];  // s_f / 127
  const int tid = threadIdx.x;
  const long long roi = blockIdx.x;
  const int b = (int)(roi / rois_per_image);
  for (int i = tid; i < kNV * V; i += blockDim.x) {
    const int ch = blockIdx.y * kNV * V + i;
    scales[i] = ch < C ? __fdiv_rn(sf[(size_t)b * C + ch], 127.0f) : 0.0f;
  }
  if (tid < 2 * R) {
    const float* box = rois + 4 * roi;
    const float x1 = __fsub_rn(__fmul_rn(box[0], spatial_scale), 0.5f);
    const float y1 = __fsub_rn(__fmul_rn(box[1], spatial_scale), 0.5f);
    const float x2 = __fsub_rn(__fmul_rn(box[2], spatial_scale), 0.5f);
    const float y2 = __fsub_rn(__fmul_rn(box[3], spatial_scale), 0.5f);
    const int axis = tid / R, cell = tid % R;
    if (axis) {
      build_cell<S>(y1, __fdiv_rn(__fsub_rn(y2, y1), (float)R), cell, H,
                    &cells[1][cell]);
    } else {
      build_cell<S>(x1, __fdiv_rn(__fsub_rn(x2, x1), (float)R), cell, W,
                    &cells[0][cell]);
    }
  }
  __syncthreads();

  // the plain version's order: the longer axis first (x when W >= H). A
  // thread holds one cell of that axis and walks the cells of the other.
  const bool xfirst = W >= H;
  const int fa = xfirst ? 0 : 1, wa = 1 - fa;
  const int v = tid % kNV, own = tid / kNV;
  const int c = (blockIdx.y * kNV + v) * V;
  if (c >= C) return;
  const int fstride = xfirst ? C : W * C;    // a tap of the thread's axis
  const int wstride = xfirst ? W * C : C;    // a tap of the walked axis
  const int ostride = (xfirst ? R : 1) * C;  // a walked cell's output
  const int8_t* qb = q + (long long)b * H * W * C + c;
  T* ob = out + ((roi * R + (xfirst ? 0 : own)) * R + (xfirst ? own : 0)) * C
          + c;
  const float* scale = scales + v * V;
  const int n = cells[fa][own].n;
  int fo[kTaps], fq[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    fo[j] = j < n ? cells[fa][own].idx[j] * fstride : 0;
    fq[j] = j < n ? cells[fa][own].q[j] : 0;
  }
  using Raw = typename S8<V>::Raw;
  // the first contraction at footprint line g, requantised: every load
  // issued before the first is used
  constexpr int kG = (kTaps + 3) / 4;      // dp4a groups of 4 taps
  int fqp[kG];
#pragma unroll
  for (int gq = 0; gq < kG; ++gq) {
    int w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * gq + k;
      if (j < kTaps) w |= (fq[j] & 0xff) << (8 * k);
    }
    fqp[gq] = w;
  }
  auto contract = [&](int* dst, int g) {
    const int8_t* p = qb + (long long)g * wstride;
    if constexpr (V == 8) {
      uint2 r[4 * kG];
#pragma unroll
      for (int j = 0; j < 4 * kG; ++j) {
        r[j] = (j < kTaps && j < n) ? S8<V>::fetch(p + fo[j])
                                    : make_uint2(0u, 0u);
      }
      int t[V];
#pragma unroll
      for (int e = 0; e < V; ++e) t[e] = 0;
#pragma unroll
      for (int gq = 0; gq < kG; ++gq) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned sel = e | ((e + 4) << 4);
          const unsigned lx = __byte_perm(r[4 * gq].x, r[4 * gq + 1].x, sel);
          const unsigned hx = __byte_perm(r[4 * gq + 2].x, r[4 * gq + 3].x,
                                          sel);
          t[e] = __dp4a((int)__byte_perm(lx, hx, 0x5410), fqp[gq], t[e]);
          const unsigned ly = __byte_perm(r[4 * gq].y, r[4 * gq + 1].y, sel);
          const unsigned hy = __byte_perm(r[4 * gq + 2].y, r[4 * gq + 3].y,
                                          sel);
          t[e + 4] = __dp4a((int)__byte_perm(ly, hy, 0x5410), fqp[gq],
                            t[e + 4]);
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = requant(t[e]);
    } else {
      Raw r[kTaps];
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        if (j < n) r[j] = S8<V>::fetch(p + fo[j]);
      }
      int t[V];
#pragma unroll
      for (int e = 0; e < V; ++e) t[e] = 0;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        if (j < n) {
          int f[V];
          S8<V>::unpack(r[j], f);
#pragma unroll
          for (int e = 0; e < V; ++e) t[e] += fq[j] * f[e];
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = requant(t[e]);
    }
  };

  int ta[V], tb[V];       // the requantised lines ga and gb
  int ga = -1, gb = -1;
  bool b_newer = true;    // which of the two was computed last
  for (int cell = 0; cell < R; ++cell) {
    const Cell<S>& wc = cells[wa][cell];
    const int m = wc.n;
    int acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      if (j >= m) break;
      const int g = wc.idx[j];
      const int wq = wc.q[j];
      bool use_a;
      if (g == ga) {
        use_a = true;
      } else if (g == gb) {
        use_a = false;
      } else if (b_newer) {
        contract(ta, g);
        ga = g;
        b_newer = false;
        use_a = true;
      } else {
        contract(tb, g);
        gb = g;
        b_newer = true;
        use_a = false;
      }
      if (use_a) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += wq * ta[e];
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += wq * tb[e];
      }
    }
    float o32[V];
#pragma unroll
    for (int e = 0; e < V; ++e) o32[e] = __fmul_rn((float)acc[e], scale[e]);
    Store<T, V>::run(ob + (long long)cell * ostride, o32);
  }
}

template <typename T, int V, int S, int kRows>
int launch_roi(const int8_t* q, const float* sf, const float* rois, T* out,
               int H, int W, int C, int total_rois, int rois_per_image,
               float spatial_scale, int res, cudaStream_t s) {
  dim3 grid((unsigned)total_rois, (unsigned)((C + kNV * V - 1) / (kNV * V)));
  roi_align_int8_kernel<T, V, S, kRows><<<grid, res * kNV, 0, s>>>(
      q, sf, rois, out, H, W, C, rois_per_image, spatial_scale, res);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch(const void* feats, const void* rois, void* out, void* amax,
           void* q, void* sf, int B, int H, int W, int C, int total_rois,
           int rois_per_image, float spatial_scale, int res, int sampling,
           cudaStream_t stream) {
  const int P = H * W;
  const int cblocks = (C + kThreads - 1) / kThreads;
  int splits = (2 * 132 + B * cblocks - 1) / (B * cblocks);
  splits = std::max(1, std::min(splits, (P + 63) / 64));
  int per_split = (P + splits - 1) / splits;
  roi_int8_absmax_kernel<T><<<dim3(B, cblocks, splits), kThreads, 0,
                              stream>>>((const T*)feats, (int*)amax, P, C,
                                        per_split);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int vblocks = (C / V + kThreads - 1) / kThreads;
  splits = (4 * 132 + B * vblocks - 1) / (B * vblocks);
  splits = std::max(1, std::min(splits, P));
  per_split = (P + splits - 1) / splits;
  roi_int8_quant_kernel<T, V><<<dim3((P + per_split - 1) / per_split,
                                     vblocks, B),
                                kThreads, 0, stream>>>(
      (const T*)feats, (const int*)amax, (int8_t*)q, (float*)sf, P, C,
      per_split);
  err = (int)cudaGetLastError();
  if (err) return err;
  // res * sampling <= 32: past 14 rows the sampling ratio is 1 or 2
  auto run = res > kFewRows
                 ? (sampling == 1 ? &launch_roi<T, V, 1, kMaxRes>
                                  : &launch_roi<T, V, 2, kMaxRes>)
             : sampling == 1 ? &launch_roi<T, V, 1, kFewRows>
             : sampling == 2 ? &launch_roi<T, V, 2, kFewRows>
             : sampling == 3 ? &launch_roi<T, V, 3, kFewRows>
                             : &launch_roi<T, V, 4, kFewRows>;
  return run((const int8_t*)q, (const float*)sf, (const float*)rois, (T*)out,
             H, W, C, total_rois, rois_per_image, spatial_scale, res,
             stream);
}

}  // namespace

// feats (B, H, W, C) NHWC, dtype 0 = float32, 1 = bfloat16; rois
// (total_rois, 4) float32, image b owning rows [b * rois_per_image,
// (b + 1) * rois_per_image); out (total_rois, res, res, C) in the features'
// dtype. Scratch from the caller: amax (B, C) int32 zeroed, q (B, H, W, C)
// int8, sf (B, C) float32. res * sampling <= 32, sampling <= 4, and one
// image's map holds fewer than 2**31 values. Returns the CUDA error code of
// the launches.
extern "C" int coin_roi_align_int8_fwd(const void* feats, const void* rois,
                                       void* out, void* amax, void* q,
                                       void* sf, int B, int H, int W, int C,
                                       int total_rois, int rois_per_image,
                                       float spatial_scale, int res,
                                       int sampling, int dtype,
                                       void* stream) {
  if (res <= 0 || sampling < 1 || sampling > kMaxSampling ||
      res * sampling > kMaxRes || total_rois <= 0 || B <= 0 || H <= 0 ||
      W <= 0 || C <= 0 || (long long)H * W * C >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = C % 8 == 0 &&
                   (((uintptr_t)feats | (uintptr_t)out | (uintptr_t)q) % 16)
                       == 0;
  if (dtype == 0) {
    auto run = vec ? &launch<float, 8> : &launch<float, 1>;
    return run(feats, rois, out, amax, q, sf, B, H, W, C, total_rois,
               rois_per_image, spatial_scale, res, sampling, s);
  }
  if (dtype == 1) {
    auto run = vec ? &launch<__nv_bfloat16, 8> : &launch<__nv_bfloat16, 1>;
    return run(feats, rois, out, amax, q, sf, B, H, W, C, total_rois,
               rois_per_image, spatial_scale, res, sampling, s);
  }
  return (int)cudaErrorInvalidValue;
}
