// K2 quantisation · dynamic int8 of activations, gradients and weights, one
// launch per tensor.
//
// Replaces: coin_tpu/ops/qconv.py `_quantize_x` / `_per_tensor_scale` /
// `_quant` (:49-80) and the weight quantisation inside `_fwd_parts` (:91-93,
// per output channel) and `_vjp_bwd` (:190-193, per input channel, flipped
// and transposed for the dgrad conv); the same arithmetic as
// coin_tpu/models/clip_resnet.py `Int8Conv` (:82-86).
//
//   scale = max(max|x|, 1e-12) / 127           (__fdiv_rn)
//   q     = clip(rint(x / scale), -127, 127)  (__fdiv_rn, half to even)
// the IEEE operations of the JAX source, in its order. A NaN propagates as in
// JAX: it makes its segment's abs-max and scale NaN, and every value quantised
// with a NaN scale becomes 0 (XLA's NaN -> s8 convert).
//
// Bound: bytes. A scale of the whole tensor makes a second read of it the
// floor: the function reads x (f32 or bf16) once, writes q (s8) once and, for
// the int8 weight gradient, the same s8 values once more in K2 wgrad's
// layout. At the res5 input of the training step (1728 crops of 14 x 14 x 1024
// bf16) that is 0.31 ms at 3.35 TB/s.
//
// Design.
// - One launch per activation tensor (`quant_tensor_kernel`): a persistent
//   grid of at most the blocks that fit on the card at once takes the
//   abs-max in one pass (16-byte loads, an integer max over the bits of the
//   non-negative floats: exact in any order, and a NaN's bits exceed those
//   of every number; each block writes its own partial, so no scratch needs
//   zeroing), meets at a grid-wide barrier (a counter and a generation word
//   that the last block to arrive resets, so the barrier is ready for the
//   next launch; a wait past about ten seconds traps instead of hanging the
//   card), then every block reduces the partials to the scale and
//   quantises. The quantise pass walks the tensor backwards: its first
//   reads find in L2 what the abs-max pass read last (the 50 MB L2 holds
//   half of a 7 x 7 x 512 res5 tensor). Zeros skip the division (a ReLU's
//   output is half zeros).
// - With a layout (`LAYOUT`, the int8 weight gradient's operands, mode
//   qt = 1) the quantise pass writes the NHWC s8 tensor that the forward or
//   dgrad conv gathers and, from the same registers, K2 wgrad's channel-major
//   layout (ops/qconv.wgrad_layout_plain): a tile is 128 positions (128
//   images at one pixel of the padded grid for k > 1, 128 consecutive pixels
//   for k = 1) x 64 channels, staged in shared memory as rows of positions
//   and written out as 128-byte rows of channels after a 4 x 4 byte
//   transpose in registers; halo tiles write zeros without reading. So the
//   wgrad's own layout pass, a re-read of both s8 tensors, leaves the step.
// - Per-sample scales (`quant_sample_kernel`): a block owns whole samples,
//   so no barrier: abs-max forwards, then quantise backwards through L2.
// - Both weight quantisations of the int8 dgrad modes
//   (`quant_weight_pair_kernel`): one launch reads w for both abs-max
//   reductions at once (32 x 32 (o, i) tiles; a partial max per tile for
//   each row and each column), meets at the barrier, then reads each tile
//   once more into shared memory and writes the per-output s8 weights
//   (O, k, k, I) and the flipped, transposed per-input ones (I, k, k, O),
//   both in 32-byte rows. The backward keeps them instead of quantising
//   again.
// - The serving conv's per-output weights (`quant_weight_kernel`): a block
//   per output channel.
// The wrapper passes a scratch of the barrier and the partials that lives
// as long as its device: launches that share it run in one stream's order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kWatchdogCycles = 20000000000LL;  // about ten seconds
constexpr int kPart = 32;    // scratch word of the first partial
constexpr int kTileP = 128;  // positions of a layout tile
constexpr int kTileC = 64;   // channels of a layout tile
constexpr int kRowW = kTileC / 4 + 1;  // words of a staged position (+1: banks)
constexpr int kWT = 32;      // outputs and inputs of a weight tile
constexpr int kMaxKK = 9;    // taps of the largest weight the pair kernel takes

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(uint16_t b) {  // bf16 bits
  return __uint_as_float(((unsigned)b) << 16);
}

// |v| as the bits of a non-negative float: their unsigned order is the
// float order, with NaN above +inf.
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// max(amax, 1e-12) / 127, NaN kept (jnp.maximum propagates it; fmaxf would not).
__device__ __forceinline__ float scale_of(unsigned amax_bits) {
  const float a = __uint_as_float(amax_bits);
  return __fdiv_rn(a != a ? a : fmaxf(a, 1e-12f), 127.0f);
}

// a zero is 0 for every scale; it skips the division, whose check for
// special operands sends a zero numerator down its slow path
__device__ __forceinline__ int quant(float v, float s) {
  if (v == 0.0f) return 0;
  float r = rintf(__fdiv_rn(v, s));
  if (r != r) return 0;
  return (int)fminf(fmaxf(r, -127.0f), 127.0f);
}

__device__ __forceinline__ unsigned block_max(unsigned m) {
  __shared__ unsigned red[kThreads / 32];
  for (int o = 16; o; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? red[threadIdx.x] : 0u;
    for (int o = 16; o; o >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) red[0] = m;
  }
  __syncthreads();
  m = red[0];
  __syncthreads();
  return m;
}

// Every block of the grid waits here until all have arrived. bar[0] counts
// the arrivals, bar[1] is the generation; the last block resets the count
// before it releases the others. The grid never exceeds the blocks that are
// resident at once, so each block that waits waits on blocks that run.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const long long start = clock64();
      while (*gen == g) {
        __nanosleep(100);
        if (clock64() - start > kWatchdogCycles) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// the largest of the grid's partials, read past L1
__device__ __forceinline__ unsigned partials_max(const unsigned* part, int n) {
  unsigned m = 0u;
  for (int b = threadIdx.x; b < n; b += kThreads) m = max(m, __ldcg(part + b));
  return block_max(m);
}

__device__ __forceinline__ void load8(const uint16_t* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint16_t* e = reinterpret_cast<const uint16_t*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = to_f(e[j]);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ uint32_t pack4(const float* v, float s) {
  uint32_t p = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    p |= ((uint32_t)(quant(v[j], s) & 0xff)) << (8 * j);
  return p;
}

// the abs-max of one 16-byte vector of values
template <typename T>
__device__ __forceinline__ unsigned vec_max(const uint4& u, unsigned m) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < 16 / (int)sizeof(T); ++j)
    m = max(m, abs_bits(to_f(e[j])));
  return m;
}

// q[i] of vector i: its 16 / sizeof(T) values quantised
template <typename T>
__device__ __forceinline__ void vec_quant(const uint4& u, float s, int8_t* q,
                                          long long i) {
  constexpr int V = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&u);
  float v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = to_f(e[j]);
  if constexpr (V == 8)
    reinterpret_cast<uint2*>(q)[i] = make_uint2(pack4(v, s), pack4(v + 4, s));
  else
    reinterpret_cast<uint32_t*>(q)[i] = pack4(v, s);
}

// abs-max of vectors [0, nv) of x, vector i by thread i mod `step` from
// `first`
template <typename T>
__device__ __forceinline__ unsigned max_pass(const uint4* x, long long nv,
                                             long long first, long long step,
                                             unsigned m) {
  for (long long i = first; i < nv; i += step) m = vec_max<T>(x[i], m);
  return m;
}

// quantise vectors [0, nv) of x backwards, from vector nv - 1 - first
template <typename T>
__device__ __forceinline__ void quant_pass(const uint4* x, long long nv,
                                           long long first, long long step,
                                           float s, int8_t* q) {
  for (long long i = nv - 1 - first; i >= 0; i -= step)
    vec_quant<T>(x[i], s, q, i);
}

// rows r0..r3 (one position each, four channels each) -> four words, one per
// channel, holding the four positions
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&c)[4]) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}

struct Tensor {
  const void* x;
  long long n;     // values
  int8_t* q;
  float* scale;
  unsigned* bar;   // scratch: the barrier, then the partials at kPart
  // the layout (LAYOUT): x is (N, H, W, C); lay (C, Pp) over groups of 128
  // positions, IB images per pixel of the Hg x Wg grid (IB 1: pixels)
  int8_t* lay;
  int N, H, W, C, Hg, Wg, IB;
  long long Pp, groups;
};

// One tile of the layout: positions [128 g, 128 g + 128) x channels
// [c0, c0 + 64): quantise, write NHWC, stage, write the channel rows.
template <typename T, bool VEC>
__device__ __forceinline__ void layout_tile(const Tensor& p, float s,
                                            long long g, int c0,
                                            uint32_t* S) {
  const T* x = static_cast<const T*>(p.x);
  const int t = threadIdx.x, oct = t & 7;
  int hh = 0, ww = 0;
  long long blk = 0;
  bool halo = false;
  if (p.IB > 1) {
    ww = (int)(g % p.Wg);
    hh = (int)((g / p.Wg) % p.Hg);
    blk = g / p.Wg / p.Hg;
    halo = hh >= p.H || ww >= p.W;
  }
  const long long pixels = (long long)p.N * p.H * p.W;
  const int c = c0 + oct * 8;
#pragma unroll
  for (int r = 0; r < kTileP / 32; ++r) {
    const int pos = (t >> 3) + 32 * r;
    long long pix;
    bool valid;
    if (p.IB > 1) {
      const long long n = blk * p.IB + pos;
      valid = !halo && n < p.N;
      pix = (n * p.H + hh) * p.W + ww;
    } else {
      pix = g * kTileP + pos;
      valid = pix < pixels;
    }
    uint32_t lo = 0, hi = 0;
    if (valid && c < p.C) {
      const long long at = pix * p.C + c;
      if (VEC) {
        float v[8];
        load8(x + at, v);
        lo = pack4(v, s);
        hi = pack4(v + 4, s);
        *reinterpret_cast<uint2*>(p.q + at) = make_uint2(lo, hi);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (c + j < p.C) {
            const uint32_t b = (uint32_t)(quant(to_f(x[at + j]), s) & 0xff);
            p.q[at + j] = (int8_t)b;
            if (j < 4) lo |= b << (8 * j); else hi |= b << (8 * (j - 4));
          }
        }
      }
    }
    S[pos * kRowW + oct * 2] = lo;
    S[pos * kRowW + oct * 2 + 1] = hi;
  }
  __syncthreads();
  if (t < kTileP) {  // 16 channel quads x 8 groups of 16 positions
    const int cq = t & 15, pg = t >> 4;
    const long long off = g * kTileP + pg * 16;
    uint32_t rows[4][4];  // [channel][word of 4 positions]
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t r4[4] = {S[(pg * 16 + 4 * k) * kRowW + cq],
                              S[(pg * 16 + 4 * k + 1) * kRowW + cq],
                              S[(pg * 16 + 4 * k + 2) * kRowW + cq],
                              S[(pg * 16 + 4 * k + 3) * kRowW + cq]};
      uint32_t col[4];
      transpose4(r4, col);
#pragma unroll
      for (int i = 0; i < 4; ++i) rows[i][k] = col[i];
    }
    if (off < p.Pp) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ch = c0 + 4 * cq + i;
        if (ch < p.C)
          *reinterpret_cast<uint4*>(p.lay + (long long)ch * p.Pp + off) =
              make_uint4(rows[i][0], rows[i][1], rows[i][2], rows[i][3]);
      }
    }
  }
  __syncthreads();
}

// One scale for the tensor. VEC: 16-byte loads (without LAYOUT: n a multiple
// of the vector; with it: C a multiple of 8), x 16-byte aligned.
template <typename T, bool VEC, bool LAYOUT>
__global__ void __launch_bounds__(kThreads)
quant_tensor_kernel(Tensor p) {
  constexpr int V = 16 / sizeof(T);
  __shared__ uint32_t S[LAYOUT ? kTileP * kRowW : 1];
  const T* x = static_cast<const T*>(p.x);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = p.n;
  const long long nv = VEC ? n / V : 0;
  unsigned m = max_pass<T>(reinterpret_cast<const uint4*>(x), nv, t0, stride,
                           0u);
  for (long long i = nv * V + t0; i < n; i += stride)
    m = max(m, abs_bits(to_f(x[i])));
  m = block_max(m);
  if (threadIdx.x == 0) p.bar[kPart + blockIdx.x] = m;
  grid_sync(p.bar);
  const float s = scale_of(partials_max(p.bar + kPart, gridDim.x));
  if (blockIdx.x == 0 && threadIdx.x == 0) p.scale[0] = s;
  if constexpr (LAYOUT) {
    const int chunks = (p.C + kTileC - 1) / kTileC;
    const long long tiles = p.groups * chunks;
    for (long long ti = tiles - 1 - blockIdx.x; ti >= 0; ti -= gridDim.x)
      layout_tile<T, VEC>(p, s, ti / chunks, (int)(ti % chunks) * kTileC, S);
  } else {
    // backwards: the first reads find what the abs-max pass read last
    quant_pass<T>(reinterpret_cast<const uint4*>(x), nv, t0, stride, s, p.q);
    for (long long i = n - 1 - t0; i >= nv * V; i -= stride)
      p.q[i] = (int8_t)quant(to_f(x[i]), s);
  }
}

// One scale per segment of `per` values; a block owns whole segments.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
quant_sample_kernel(const T* __restrict__ x, long long per, int nseg,
              int8_t* __restrict__ q, float* __restrict__ scale) {
  constexpr int V = 16 / sizeof(T);
  const long long nv = VEC ? per / V : 0;
  for (int seg = blockIdx.x; seg < nseg; seg += gridDim.x) {
    const T* xs = x + (long long)seg * per;
    int8_t* qs = q + (long long)seg * per;
    unsigned m = max_pass<T>(reinterpret_cast<const uint4*>(xs), nv,
                             threadIdx.x, kThreads, 0u);
    for (long long i = nv * V + threadIdx.x; i < per; i += kThreads)
      m = max(m, abs_bits(to_f(xs[i])));
    const float s = scale_of(block_max(m));
    if (threadIdx.x == 0) scale[seg] = s;
    quant_pass<T>(reinterpret_cast<const uint4*>(xs), nv, threadIdx.x,
                  kThreads, s, qs);
    for (long long i = per - 1 - threadIdx.x; i >= nv * V; i -= kThreads)
      qs[i] = (int8_t)quant(to_f(xs[i]), s);
  }
}

struct Weights {
  const float* w;  // (O, I, k, k)
  int O, I, kk;
  int8_t* wq;      // (O, k, k, I), per output channel
  float* ks;       // (O,)
  int8_t* wt;      // (I, k, k, O), per input channel, flipped
  float* ksi;      // (I,)
  unsigned* prow;  // (tiles of I, O): partial max of each output
  unsigned* pcol;  // (tiles of O, I): partial max of each input
  unsigned* bar;
};

// No clip: |w / s| never rounds past 127 (:93, :192); a NaN in a channel
// makes its scale NaN and its values 0, as in quant().
__global__ void __launch_bounds__(kThreads)
quant_weight_pair_kernel(Weights p) {
  __shared__ float Ws[kWT * (kWT * kMaxKK + 1)];
  __shared__ unsigned cs[kWT];
  __shared__ float so[kWT], si[kWT];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, kk = p.kk;
  const int tiles_o = (p.O + kWT - 1) / kWT, tiles_i = (p.I + kWT - 1) / kWT;
  const int tiles = tiles_o * tiles_i;
  const int L = kWT * kk + 1;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int to = tile / tiles_i, ti = tile % tiles_i;
    const int o0 = to * kWT, i0 = ti * kWT;
    const int no = min(kWT, p.O - o0), ni = min(kWT, p.I - i0);
    const int len = ni * kk;
    if (t < kWT) cs[t] = 0u;
    __syncthreads();
    for (int r = warp; r < no; r += kThreads / 32) {
      const float* row = p.w + ((long long)(o0 + r) * p.I + i0) * kk;
      unsigned m = 0u;
      for (int e = lane; e < len; e += 32) {
        const unsigned b = abs_bits(row[e]);
        m = max(m, b);
        atomicMax(&cs[e / kk], b);
      }
      for (int o = 16; o; o >>= 1)
        m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) p.prow[(long long)ti * p.O + o0 + r] = m;
    }
    __syncthreads();
    if (t < ni) p.pcol[(long long)to * p.I + i0 + t] = cs[t];
    __syncthreads();
  }
  grid_sync(p.bar);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int to = tile / tiles_i, ti = tile % tiles_i;
    const int o0 = to * kWT, i0 = ti * kWT;
    const int no = min(kWT, p.O - o0), ni = min(kWT, p.I - i0);
    const int len = ni * kk;
    if (t < no) {
      unsigned m = 0u;
      for (int j = 0; j < tiles_i; ++j)
        m = max(m, __ldcg(p.prow + (long long)j * p.O + o0 + t));
      so[t] = scale_of(m);
      if (ti == 0) p.ks[o0 + t] = so[t];
    } else if (t >= kWT && t - kWT < ni) {
      const int i = t - kWT;
      unsigned m = 0u;
      for (int j = 0; j < tiles_o; ++j)
        m = max(m, __ldcg(p.pcol + (long long)j * p.I + i0 + i));
      si[i] = scale_of(m);
      if (to == 0) p.ksi[i0 + i] = si[i];
    }
    for (int idx = t; idx < no * len; idx += kThreads) {
      const int r = idx / len, e = idx - r * len;
      Ws[r * L + e] = p.w[((long long)(o0 + r) * p.I + i0) * kk + e];
    }
    __syncthreads();
    for (int idx = t; idx < no * kk * kWT; idx += kThreads) {  // i fastest
      const int i = idx & (kWT - 1), rt = idx / kWT;
      const int tap = rt % kk, r = rt / kk;
      if (i < ni)
        p.wq[((long long)(o0 + r) * kk + tap) * p.I + i0 + i] =
            (int8_t)quant(Ws[r * L + i * kk + tap], so[r]);
    }
    for (int idx = t; idx < ni * kk * kWT; idx += kThreads) {  // o fastest
      const int r = idx & (kWT - 1), it = idx / kWT;
      const int tap = it % kk, i = it / kk;
      if (r < no)
        p.wt[((long long)(i0 + i) * kk + (kk - 1 - tap)) * p.O + o0 + r] =
            (int8_t)quant(Ws[r * L + i * kk + tap], si[i]);
    }
    __syncthreads();
  }
}

// w: (O, I, k, k) f32 -> wq (O, k, k, I), one scale per output channel.
__global__ void __launch_bounds__(kThreads)
quant_weight_kernel(const float* __restrict__ w, int I, int kk,
              int8_t* __restrict__ wq, float* __restrict__ ks) {
  const int o = blockIdx.x;
  const int count = I * kk;
  const float* row = w + (long long)o * count;
  unsigned m = 0u;
  for (int j = threadIdx.x; j < count; j += kThreads)
    m = max(m, abs_bits(row[j]));
  const float s = scale_of(block_max(m));
  if (threadIdx.x == 0) ks[o] = s;
  for (int j = threadIdx.x; j < count; j += kThreads) {
    const int i = j / kk, tap = j - i * kk;
    wq[((long long)o * kk + tap) * I + i] = (int8_t)quant(row[j], s);
  }
}

// The blocks of `kernel` that the card holds at once (cached per kernel).
int resident_blocks(const void* kernel) {
  static const void* keys[16];
  static int values[16];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (keys[i] == kernel) return values[i];
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int v = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (used < 16) {
    keys[used] = kernel;
    values[used] = v;
    ++used;
  }
  return v;
}

// the layout's row: the grid of positions rounded up to 16 bytes (the same
// as qconv_wgrad.cu and ops/qconv.wgrad_positions)
long long positions(int N, int H, int W, int k) {
  const int p = k / 2, ib = k > 1 ? 128 : 1;
  const long long grid = (long long)(N + ib - 1) / ib * (H + p) * (W + p) * ib;
  return (grid + 15) / 16 * 16;
}

template <typename T, bool VEC, bool LAYOUT>
int launch_tensor(Tensor p, int cap, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  auto kernel = quant_tensor_kernel<T, VEC, LAYOUT>;
  long long want = (p.n / V + 4LL * kThreads - 1) / (4LL * kThreads);
  int grid = resident_blocks((const void*)kernel);
  if (grid > cap) grid = cap;
  if (want < grid) grid = want < 1 ? 1 : (int)want;
  kernel<<<grid, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int quantize_tensor(Tensor p, int cap, cudaStream_t st) {
  const bool aligned = (uintptr_t)p.x % 16 == 0;
  if (p.lay) {
    return (aligned && p.C % 8 == 0)
               ? launch_tensor<T, true, true>(p, cap, st)
               : launch_tensor<T, false, true>(p, cap, st);
  }
  return (aligned && p.n % (16 / sizeof(T)) == 0)
             ? launch_tensor<T, true, false>(p, cap, st)
             : launch_tensor<T, false, false>(p, cap, st);
}

template <typename T>
int quantize_samples(const void* x, long long per, int nseg, void* q,
                     float* scale, cudaStream_t st) {
  const bool vec = (uintptr_t)x % 16 == 0 && (uintptr_t)q % 8 == 0 &&
                   per % (16 / sizeof(T)) == 0;
  const void* kernel = vec ? (const void*)quant_sample_kernel<T, true>
                           : (const void*)quant_sample_kernel<T, false>;
  int grid = resident_blocks(kernel);
  if (grid > nseg) grid = nseg;
  if (vec)
    quant_sample_kernel<T, true><<<grid, kThreads, 0, st>>>(
        (const T*)x, per, nseg, (int8_t*)q, scale);
  else
    quant_sample_kernel<T, false><<<grid, kThreads, 0, st>>>(
        (const T*)x, per, nseg, (int8_t*)q, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// x: n values (dtype 0 = f32, 1 = bf16); nseg 1: one scale for the tensor,
// nseg > 1: one per sample of n / nseg values. q: n int8; scale: nseg f32.
// lay: null, or (per tensor only) K2 wgrad's (C, Pp) s8 layout of x as an
// (N, H, W, C) tensor for a k x k conv, written beside q (C a multiple of 4,
// 16-byte aligned). scratch: the barrier and partials, `words` u32 that
// start zeroed and that the kernels leave as they must find them. Returns
// the CUDA error code.
extern "C" int coin_quantize(const void* x, int dtype, long long n, int nseg,
                             void* q, float* scale, void* lay, int N, int H,
                             int W, int C, int k, unsigned* scratch,
                             int words, void* stream) {
  if (n <= 0 || nseg <= 0 || n % nseg || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (nseg > 1) {
    if (lay) return (int)cudaErrorInvalidValue;
    return dtype == 0 ? quantize_samples<float>(x, n / nseg, nseg, q, scale, st)
                      : quantize_samples<uint16_t>(x, n / nseg, nseg, q, scale,
                                                   st);
  }
  Tensor p{};
  p.x = x; p.n = n; p.q = (int8_t*)q; p.scale = scale; p.bar = scratch;
  if (lay) {
    const long long Pp = positions(N, H, W, k);
    if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 4 || k <= 0 ||
        (long long)N * H * W * C != n || Pp >= (1LL << 31) ||
        (uintptr_t)lay % 16)
      return (int)cudaErrorInvalidValue;
    const int pad = k / 2;
    p.lay = (int8_t*)lay; p.N = N; p.H = H; p.W = W; p.C = C;
    p.IB = k > 1 ? 128 : 1;
    p.Hg = H + pad; p.Wg = W + pad; p.Pp = Pp;
    p.groups = k > 1 ? (long long)(N + 127) / 128 * p.Hg * p.Wg
                     : ((long long)N * H * W + kTileP - 1) / kTileP;
  }
  const int cap = words - kPart;
  if (cap < 1) return (int)cudaErrorInvalidValue;
  return dtype == 0 ? quantize_tensor<float>(p, cap, st)
                    : quantize_tensor<uint16_t>(p, cap, st);
}

// w (O, I, k, k) f32 -> wq (O, k, k, I) and ks (O,), one scale per output
// channel (the serving conv and the int8-forward-only mode).
extern "C" int coin_quantize_weight(const float* w, int O, int I, int k,
                                    void* wq, float* ks, void* stream) {
  if (O <= 0 || I <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  quant_weight_kernel<<<O, kThreads, 0, (cudaStream_t)stream>>>(
      w, I, k * k, (int8_t*)wq, ks);
  return (int)cudaGetLastError();
}

// The u32 words of scratch that coin_quantize_weight_pair needs beside the
// shared barrier: the partials of each tile's rows and columns.
extern "C" long long coin_quantize_weight_pair_words(int O, int I) {
  return (long long)(I + kWT - 1) / kWT * O +
         (long long)(O + kWT - 1) / kWT * I;
}

// w (O, I, k, k) f32, k <= 3 -> wq (O, k, k, I), ks (O,) per output channel
// and wt (I, k, k, O) of the flipped kernel, ksi (I,) per input channel, in
// one launch. part: coin_quantize_weight_pair_words u32; scratch, words: as
// for coin_quantize.
extern "C" int coin_quantize_weight_pair(const float* w, int O, int I, int k,
                                         void* wq, float* ks, void* wt,
                                         float* ksi, unsigned* part,
                                         unsigned* scratch, int words,
                                         void* stream) {
  if (O <= 0 || I <= 0 || k <= 0 || k * k > kMaxKK || words <= kPart)
    return (int)cudaErrorInvalidValue;
  Weights p;
  p.w = w; p.O = O; p.I = I; p.kk = k * k;
  p.wq = (int8_t*)wq; p.ks = ks; p.wt = (int8_t*)wt; p.ksi = ksi;
  p.prow = part;
  p.pcol = part + (long long)(I + kWT - 1) / kWT * O;
  p.bar = scratch;
  const int tiles = ((O + kWT - 1) / kWT) * ((I + kWT - 1) / kWT);
  int grid = resident_blocks((const void*)quant_weight_pair_kernel);
  if (grid > tiles) grid = tiles;
  quant_weight_pair_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
