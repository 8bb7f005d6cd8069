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
// read once and the output written once (0.596 ms per Swin-B forward).
//
// bf16 (`wa_mma_kernel`, n <= 144): flash-attention-2 style on the tensor
// cores, mma.sync.m16n8k16 bf16 with f32 sums; 4.2 ms per Swin-B forward
// against SDPA's 5.5 (PERF.md). One block per (window, head), the heads of
// a window in neighbouring blocks (they share the lines of qkv and the
// mask), one warp per 16 query rows (9 warps at n = 144, 4 at n = 49). q,
// k and v come into shared memory by 16-byte cp.async (rows padded to
// d + 8 elements, so that ldmatrix reads are free of bank conflicts; rows
// past n are zeros), the head's bias column beside them: 37 KB at n = 144,
// d = 32, two blocks per SM. Each warp takes its Q fragments with
// ldmatrix, keeps its 16 x 144 scores in f32 registers (72 a thread),
// applies / sqrt(d), the bias (the index read from global memory two
// entries at a time, the table from shared memory) and the mask there,
// takes the row max and sum with quad shuffles (the whole row is in
// registers: the softmax is exact, no online rescaling), turns the
// probabilities, rounded to bf16, into the A fragments of p·v straight
// from the score registers, reads v with ldmatrix.trans, and rounds the
// f32 output once. Both divisions take a product with the divisor's
// correctly rounded reciprocal and one correction step on the exact
// residual (Markstein's), the correctly rounded quotient away from
// underflow at a third of __fdiv_rn's instructions. Keys >= n are -inf
// before the max; rows >= n are not stored. The products are summed in the
// tensor cores' order.
//
// f32 keeps the CUDA-core kernel (`window_attention_kernel`): tensor cores
// would need TF32. One block of 512 threads per (window, head); q, k and v are
// read straight from the packed tensor with strides into shared memory (rows
// padded to d + 1 floats against bank conflicts), and the n × n scores stay in
// dynamic shared memory (83 KB at n = 144; 141 KB in all, so one block per
// SM). Each thread computes a 4 × 4 tile of scores (4 query rows and 4 keys,
// strided so that a warp's lanes read different keys' banks), which loads 8
// values from shared memory per 16 multiply-adds instead of 2 per one; one
// warp per row takes the softmax; for p·v each thread keeps 4 rows of one
// channel, a warp reading one row of p by broadcast and neighbouring channels
// of v. Every dot product is one FMA chain in channel (or key) order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 4;                   // rows (and keys) per thread's tile
constexpr int kMaxSmem = 227 * 1024;

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

template <int D>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ table,
                        const int* __restrict__ index,
                        const float* __restrict__ mask,
                        float* __restrict__ out,
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
  const float* base = qkv + (size_t)bn * n * 3 * dim + h * D;

  for (int t = threadIdx.x; t < n * D; t += kThreads) {
    const int i = t / D, c = t % D;
    const float* row = base + (size_t)i * 3 * dim + c;
    qs[i * kStride + c] = row[0];
    ks[i * kStride + c] = row[dim];
    vs[i * D + c] = row[2 * dim];
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
      r[j] = __fdiv_rn(r[j], sum);
    }
  }
  __syncthreads();

  // out = p · v: each thread kR rows of one channel; a warp shares its
  // rows (broadcast reads of p) and reads neighbouring channels of v
  float* ob = out + (size_t)bn * n * dim + h * D;
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
      if (i < n) ob[(size_t)i * dim + c] = acc[r];
    }
  }
}

template <int D>
int launch(const void* qkv, const void* table, const void* index,
           const void* mask, void* out, int bn, int n, int heads,
           int table_rows, int mask_windows, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, D, table_rows);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = window_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bn, heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)qkv, (const float*)table, (const int*)index,
      (const float*)mask, (float*)out, n, heads, table_rows, mask_windows,
      sqrtf((float)D));
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bf16 on tensor cores
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a / b correctly rounded away from underflow, from r = RN(1 / b): the
// quotient a r corrected by one step on its exact residual (Markstein)
__device__ __forceinline__ float div_rcp(float a, float b, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
}

constexpr int kMmaKeys = 144;  // the most keys the tensor-core kernel holds

// shared memory of the tensor-core kernel: q, k, v (rows padded to d + 8)
// and the head's bias column
size_t mma_smem_bytes(int n, int d, int table_rows) {
  const int rows = n <= 64 ? 64 : kMmaKeys;
  return (size_t)3 * rows * (d + 8) * sizeof(__nv_bfloat16) +
         sizeof(float) * table_rows;
}

// KS: steps of 16 keys (the keys and the rows padded to 16 KS >= n); FULL:
// n == 16 KS, so that no key or row is padding and the index and mask rows
// are read two entries at a time
template <int D, int KS, bool FULL>
__global__ void __launch_bounds__(KS * 32, D == 32 ? 2 : 1)
    wa_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                  const float* __restrict__ table,
                  const int* __restrict__ index,
                  const float* __restrict__ mask,
                  __nv_bfloat16* __restrict__ out, int n, int heads,
                  int table_rows, int mask_windows, float sqrt_d) {
  constexpr int NK = 16 * KS, ROW = D + 8, NT = 2 * KS, CH = D / 8;
  extern __shared__ __align__(16) unsigned char wa_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(wa_smem);
  __nv_bfloat16* ks = qs + NK * ROW;
  __nv_bfloat16* vs = ks + NK * ROW;
  float* tb = reinterpret_cast<float*>(vs + NK * ROW);
  // the heads of a window in neighbouring blocks: they read the same lines
  // of qkv and the same mask
  const int h = blockIdx.x % heads, bn = blockIdx.x / heads;
  const int dim = heads * D;
  const __nv_bfloat16* base = qkv + (size_t)bn * n * 3 * dim + h * D;

  for (int t = threadIdx.x; t < NK * CH; t += blockDim.x) {
    const int r = t / CH, c = (t % CH) * 8;
    const int e = r * ROW + c;
    if (FULL || r < n) {
      const __nv_bfloat16* src = base + (size_t)r * 3 * dim + c;
      cp_async16(qs + e, src);
      cp_async16(ks + e, src + dim);
      cp_async16(vs + e, src + 2 * dim);
    } else {
      const uint4 z = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(qs + e) = z;
      *reinterpret_cast<uint4*>(ks + e) = z;
      *reinterpret_cast<uint4*>(vs + e) = z;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int t = threadIdx.x; t < table_rows; t += blockDim.x)
    tb[t] = table[(size_t)t * heads + h];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int lane = threadIdx.x % 32, row0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t4 = lane & 3;

  // scores of this warp's 16 rows against every key: s[nt] is keys
  // 8 nt .. 8 nt + 7, c0 c1 at row g, c2 c3 at row g + 8
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[nt][c] = 0.0f;
  {
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kq = 0; kq < D / 16; ++kq)
      ldsm_x4(qa[kq], qs + (row0 + (lane & 15)) * ROW + kq * 16 +
                          (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < KS; ++j) {
#pragma unroll
      for (int kq = 0; kq < D / 16; ++kq) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + (16 * j + ((lane >> 4) << 3) + (lane & 7)) * ROW +
                        kq * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j], qa[kq], bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], qa[kq], bk[2], bk[3]);
      }
    }
  }

  // / sqrt(d), + bias, + mask; keys past n -inf, rows past n left finite
  const float* mrow =
      mask == nullptr ? nullptr : mask + (size_t)(bn % mask_windows) * n * n;
  const float rs = __frcp_rn(sqrt_d);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + g + hf * 8, col = nt * 8 + 2 * t4;
      float a = s[nt][2 * hf], b = s[nt][2 * hf + 1];
      if (FULL) {
        const int e = r * n + col;
        const int2 id = __ldg(reinterpret_cast<const int2*>(index + e));
        a = __fadd_rn(div_rcp(a, sqrt_d, rs), tb[id.x]);
        b = __fadd_rn(div_rcp(b, sqrt_d, rs), tb[id.y]);
        if (mrow != nullptr) {
          const float2 m2 = __ldg(reinterpret_cast<const float2*>(mrow + e));
          a = __fadd_rn(a, m2.x);
          b = __fadd_rn(b, m2.y);
        }
      } else {
        auto one = [&](float x, int cc) {
          if (cc >= n) return -INFINITY;
          if (r >= n) return 0.0f;
          const int e = r * n + cc;
          x = __fadd_rn(div_rcp(x, sqrt_d, rs), tb[__ldg(index + e)]);
          return mrow == nullptr ? x : __fadd_rn(x, __ldg(mrow + e));
        };
        a = one(a, col);
        b = one(b, col + 1);
      }
      s[nt][2 * hf] = a;
      s[nt][2 * hf + 1] = b;
      mx[hf] = fmaxf(mx[hf], fmaxf(a, b));
    }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(~0u, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(~0u, mx[hf], 2));
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float e = expf(__fsub_rn(s[nt][c], mx[c >> 1]));
      s[nt][c] = e;
      sum[c >> 1] = __fadd_rn(sum[c >> 1], e);
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    sum[hf] = __fadd_rn(sum[hf], __shfl_xor_sync(~0u, sum[hf], 1));
    sum[hf] = __fadd_rn(sum[hf], __shfl_xor_sync(~0u, sum[hf], 2));
  }
  const float rsum[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};

  // p · v: the probabilities of keys 16 j .. 16 j + 15, rounded to bf16, are
  // the A fragment of step j as they lie in the score registers
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nt][c] = 0.0f;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const uint32_t pa[4] = {
        pack_bf16(div_rcp(s[2 * j][0], sum[0], rsum[0]),
                  div_rcp(s[2 * j][1], sum[0], rsum[0])),
        pack_bf16(div_rcp(s[2 * j][2], sum[1], rsum[1]),
                  div_rcp(s[2 * j][3], sum[1], rsum[1])),
        pack_bf16(div_rcp(s[2 * j + 1][0], sum[0], rsum[0]),
                  div_rcp(s[2 * j + 1][1], sum[0], rsum[0])),
        pack_bf16(div_rcp(s[2 * j + 1][2], sum[1], rsum[1]),
                  div_rcp(s[2 * j + 1][3], sum[1], rsum[1]))};
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t bv[4];
      ldsm_x4_t(bv, vs + (16 * j + (lane & 15)) * ROW + dn * 16 +
                        (lane >> 4) * 8);
      mma_bf16(o[2 * dn], pa, bv[0], bv[1]);
      mma_bf16(o[2 * dn + 1], pa, bv[2], bv[3]);
    }
  }

  __nv_bfloat16* ob = out + (size_t)bn * n * dim + h * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + g + hf * 8;
      if (FULL || r < n)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r * dim + nt * 8 + 2 * t4) =
            pack_bf16(o[nt][2 * hf], o[nt][2 * hf + 1]);
    }
}

template <int D, int KS, bool FULL>
int launch_mma(const void* qkv, const void* table, const void* index,
               const void* mask, void* out, int bn, int n, int heads,
               int table_rows, int mask_windows, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(n, D, table_rows);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = wa_mma_kernel<D, KS, FULL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((long long)bn * heads), KS * 32, smem, stream>>>(
      (const __nv_bfloat16*)qkv, (const float*)table, (const int*)index,
      (const float*)mask, (__nv_bfloat16*)out, n, heads, table_rows,
      mask_windows, sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* qkv, const void* table, const void* index,
                const void* mask, void* out, int bn, int n, int heads,
                int table_rows, int mask_windows, cudaStream_t stream) {
  if (n == kMmaKeys)
    return launch_mma<D, kMmaKeys / 16, true>(qkv, table, index, mask, out,
                                              bn, n, heads, table_rows,
                                              mask_windows, stream);
  if (n <= 64)
    return launch_mma<D, 4, false>(qkv, table, index, mask, out, bn, n, heads,
                                   table_rows, mask_windows, stream);
  if (n <= kMmaKeys)
    return launch_mma<D, kMmaKeys / 16, false>(qkv, table, index, mask, out,
                                               bn, n, heads, table_rows,
                                               mask_windows, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// qkv: (bn, n, 3, heads, d) contiguous, dtype 0 = f32, 1 = bf16 (n <= 144,
// qkv 16-byte and index and mask 8-byte aligned); table:
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
    return dtype ? launch_bf16<32>(qkv, table, index, mask, out, bn, n, heads,
                                   table_rows, mask_windows, s)
                 : launch<32>(qkv, table, index, mask, out, bn, n, heads,
                              table_rows, mask_windows, s);
  }
  if (d == 64) {
    return dtype ? launch_bf16<64>(qkv, table, index, mask, out, bn, n, heads,
                                   table_rows, mask_windows, s)
                 : launch<64>(qkv, table, index, mask, out, bn, n, heads,
                              table_rows, mask_windows, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" long long coin_window_attention_smem(int n, int d, int table_rows,
                                                int dtype) {
  return (long long)(dtype && n <= kMmaKeys ? mma_smem_bytes(n, d, table_rows)
                                            : smem_bytes(n, d, table_rows));
}
