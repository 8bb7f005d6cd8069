// K2 quantisation · dynamic int8 of activations, gradients and weights.
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
// Bound: bytes. An activation is read twice (abs-max, then quantise) and
// written once as s8; at the res5 input of the training step (1728 crops of
// 14 x 14 x 1024 bf16) that is 693 MB read for the function's once, about
// 0.3 ms at 3.35 TB/s. Design: 16-byte vector loads where the segment allows
// them; the abs-max is an integer max over the bits of the non-negative floats
// (exact in any order, and a NaN's bits exceed those of every number), a block
// reduction, then an atomicMax; the quantise pass computes the
// scale from the abs-max itself, so no kernel sits between the two. Weights
// (at most 2.4 M values) take one block per channel whose scale they share.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ int quant(float v, float s) {
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

// One segment (the whole tensor, or one sample) per blockIdx.y.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, long long per, unsigned* amax) {
  constexpr int V = 16 / sizeof(T);
  const T* seg = x + (long long)blockIdx.y * per;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  unsigned m = 0u;
  long long done = 0;
  if (VEC) {
    const uint4* sv = reinterpret_cast<const uint4*>(seg);
    const long long nv = per / V;
    for (long long i = t0; i < nv; i += stride) {
      uint4 u = sv[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) m = max(m, abs_bits(to_f(e[j])));
    }
    done = nv * V;
  }
  for (long long i = done + t0; i < per; i += stride)
    m = max(m, abs_bits(to_f(seg[i])));
  m = block_max(m);
  if (threadIdx.x == 0) atomicMax(amax + blockIdx.y, m);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, long long n, long long per,
                const unsigned* __restrict__ amax, int nseg,
                int8_t* __restrict__ q, float* __restrict__ scale) {
  constexpr int V = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t0 < nseg) scale[t0] = scale_of(amax[t0]);
  long long done = 0;
  if (VEC) {  // per % V == 0: a vector never straddles two segments
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const long long nv = n / V;
    for (long long i = t0; i < nv; i += stride) {
      const float s = scale_of(amax[(i * V) / per]);
      uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
      uint32_t packed[V / 4];
#pragma unroll
      for (int w = 0; w < V / 4; ++w) {
        uint32_t p = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p |= ((uint32_t)(quant(to_f(e[4 * w + j]), s) & 0xff)) << (8 * j);
        packed[w] = p;
      }
      if (V == 8) {
        reinterpret_cast<uint2*>(q)[i] = make_uint2(packed[0], packed[V / 4 - 1]);
      } else {
        reinterpret_cast<uint32_t*>(q)[i] = packed[0];
      }
    }
    done = nv * V;
  }
  for (long long i = done + t0; i < n; i += stride) {
    const float s = scale_of(amax[i / per]);
    q[i] = (int8_t)quant(to_f(x[i]), s);
  }
}

// w: (O, I, k, k) f32. per_input 0: one scale per o, wq laid out
// [O][kh][kw][I]; per_input 1: one scale per i, wq [I][kh][kw][O] holding the
// spatially flipped kernel (the dgrad conv's weights). No clip: |w / s| never
// rounds past 127 (:93, :192); a NaN in a channel makes its scale NaN and its
// values 0, as in quant().
__global__ void __launch_bounds__(kThreads)
weight_kernel(const float* __restrict__ w, int O, int I, int k,
              int per_input, int8_t* __restrict__ wq, float* __restrict__ ks) {
  const int c = blockIdx.x;
  const int kk = k * k;
  const int other = per_input ? O : I;
  const int count = other * kk;
  auto src = [&](int j) -> long long {
    const int a = j / kk, t = j - a * kk;
    return per_input ? ((long long)a * I + c) * kk + t
                     : ((long long)c * I + a) * kk + t;
  };
  unsigned m = 0u;
  for (int j = threadIdx.x; j < count; j += kThreads)
    m = max(m, abs_bits(w[src(j)]));
  const float s = scale_of(block_max(m));
  if (threadIdx.x == 0) ks[c] = s;
  for (int j = threadIdx.x; j < count; j += kThreads) {
    const int a = j / kk, t = j - a * kk;
    const int tap = per_input ? kk - 1 - t : t;
    wq[((long long)c * kk + tap) * other + a] =
        (int8_t)quant(w[src(j)], s);
  }
}

template <typename T>
int launch_quantize(const void* x, long long n, long long per, int nseg,
                    void* q, float* scale, unsigned* amax, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (per % V == 0) && ((uintptr_t)x % 16 == 0) &&
                   ((uintptr_t)q % 16 == 0);
  long long per_blocks = (per / V + kThreads - 1) / kThreads;
  if (per_blocks < 1) per_blocks = 1;
  long long cap = (132 * 8 + nseg - 1) / nseg;
  if (cap < 1) cap = 1;
  if (per_blocks > cap) per_blocks = cap;
  dim3 grid((unsigned)per_blocks, (unsigned)nseg);
  long long qblocks = (n / V + kThreads - 1) / kThreads;
  if (qblocks < (nseg + kThreads - 1) / kThreads)
    qblocks = (nseg + kThreads - 1) / kThreads;
  if (qblocks > 132 * 16) qblocks = 132 * 16;
  if (qblocks < 1) qblocks = 1;
  const T* xt = (const T*)x;
  if (vec) {
    absmax_kernel<T, true><<<grid, kThreads, 0, st>>>(xt, per, amax);
    quantize_kernel<T, true><<<(unsigned)qblocks, kThreads, 0, st>>>(
        xt, n, per, amax, nseg, (int8_t*)q, scale);
  } else {
    absmax_kernel<T, false><<<grid, kThreads, 0, st>>>(xt, per, amax);
    quantize_kernel<T, false><<<(unsigned)qblocks, kThreads, 0, st>>>(
        xt, n, per, amax, nseg, (int8_t*)q, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: n values (dtype 0 = f32, 1 = bf16) in nseg segments of per values
// (nseg 1: one scale for the tensor; nseg N: one per sample). q: n int8;
// scale: nseg f32; amax: nseg u32 of scratch. Returns the CUDA error code.
extern "C" int coin_quantize(const void* x, int dtype, long long n,
                             long long per, int nseg, void* q, float* scale,
                             unsigned* amax, void* stream) {
  if (n <= 0 || nseg <= 0 || per * nseg != n) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(unsigned) * nseg, st);
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0) return launch_quantize<float>(x, n, per, nseg, q, scale, amax, st);
  if (dtype == 1) return launch_quantize<uint16_t>(x, n, per, nseg, q, scale, amax, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int coin_quantize_weight(const float* w, int O, int I, int k,
                                    int per_input, void* wq, float* ks,
                                    void* stream) {
  if (O <= 0 || I <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  weight_kernel<<<per_input ? I : O, kThreads, 0, (cudaStream_t)stream>>>(
      w, O, I, k, per_input, (int8_t*)wq, ks);
  return (int)cudaGetLastError();
}
