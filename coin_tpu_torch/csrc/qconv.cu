// K2 forward and dgrad, K2s · s8 x s8 -> s32 implicit-GEMM convolution over
// NHWC with an f32 rescale.
//
// Replaces: coin_tpu/ops/qconv.py `_fwd_parts` (:83-98, the forward of
// `int8_train_conv`), the int8 dgrad of `_vjp_bwd` (:184-195) and
// coin_tpu/models/clip_resnet.py `Int8Conv` (:62-92): XLA's
// conv_general_dilated with preferred_element_type=int32, then
//   out = f32(acc) * (row_scale * col_scale)
// with row_scale the activation's (one, or one per sample) and col_scale the
// weight's per output channel, multiplied in exactly that order.
//
// GEMM view: M = N * Ho * Wo output pixels, N' = O channels, K = k * k * C;
// A[m][(kh, kw, c)] = x[n, ho * s - p + kh, wo * s - p + kw, c] (0 outside),
// B[o][(kh, kw, c)] = w (laid out [O][kh][kw][C] by quantize.cu).
//
// Bound: operations. res5 of the training step (1728 crops) is about 2e12
// MACs per pass: 2 ms at the 1979 TOPS int8 dense peak. Design: 128 x BN
// tiles, 8 warps (2 x 4), each warp 64 x BN/4 of mma.sync m16n8k32 s8 tensor
// core products on fragments read from shared memory (rows padded to 48
// bytes: no bank conflicts); a 3-stage cp.async pipeline of 16-byte copies
// with zero fill for the padding and the ragged edges (C % 16 == 0). Other
// shapes (the stem conv, C = 3) gather bytes into the same tiles. wgmma and
// TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBK = 32;
constexpr int kRow = 48;  // bytes per smem row: 32 of data, 16 of padding
constexpr int kThreads = 256;
constexpr int kStages = 3;

struct Conv {
  const int8_t* x;
  const int8_t* w;
  const float* rs;  // row scales: 1 or N
  const float* cs;  // column scales: O
  float* out;
  int N, H, W, C, O, k, stride, pad, Ho, Wo, K, per_sample;
  long long M;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int sz = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(sz));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int NI>
__device__ __forceinline__ void tile_mma(const int8_t* As, const int8_t* Bs,
                                         int wm, int wn, int lane,
                                         int (&acc)[4][NI][4]) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[4][4], b[NI][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int8_t* r0 = As + (wm * 64 + mi * 16 + g) * kRow + t * 4;
    const int8_t* r1 = r0 + 8 * kRow;
    a[mi][0] = lds32(r0);
    a[mi][1] = lds32(r1);
    a[mi][2] = lds32(r0 + 16);
    a[mi][3] = lds32(r1 + 16);
  }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int8_t* c0 = Bs + (wn * NI * 8 + ni * 8 + g) * kRow + t * 4;
    b[ni][0] = lds32(c0);
    b[ni][1] = lds32(c0 + 16);
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
}

// The A byte of output pixel m at GEMM column kk (the gather path).
__device__ __forceinline__ int8_t a_byte(const Conv& p, long long m, int kk) {
  if (m >= p.M || kk >= p.K) return 0;
  const int hw = p.Ho * p.Wo;
  const int n = (int)(m / hw);
  const int rem = (int)(m - (long long)n * hw);
  const int ho = rem / p.Wo, wo = rem - (rem / p.Wo) * p.Wo;
  const int tap = kk / p.C, c = kk - tap * p.C;
  const int kh = tap / p.k, kw = tap - kh * p.k;
  const int hi = ho * p.stride - p.pad + kh, wi = wo * p.stride - p.pad + kw;
  if (hi < 0 || hi >= p.H || wi < 0 || wi >= p.W) return 0;
  return p.x[(((long long)n * p.H + hi) * p.W + wi) * p.C + c];
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads) qconv_kernel(Conv p) {
  constexpr int NI = BN / 32;
  constexpr int STAGES = VEC ? kStages : 1;
  __shared__ __align__(16) int8_t As[STAGES][kBM * kRow];
  __shared__ __align__(16) int8_t Bs[STAGES][BN * kRow];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int ktiles = (p.K + kBK - 1) / kBK;

  int acc[4][NI][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  if constexpr (VEC) {
    // this thread's A row and 16-byte half, decoded once
    const int ar = tid >> 1, half = tid & 1;
    const long long m = m0 + ar;
    int an = 0, hi0 = 0, wi0 = 0;
    if (m < p.M) {
      const int hw = p.Ho * p.Wo;
      an = (int)(m / hw);
      const int rem = (int)(m - (long long)an * hw);
      hi0 = (rem / p.Wo) * p.stride - p.pad;
      wi0 = (rem % p.Wo) * p.stride - p.pad;
    }
    const bool b_thread = tid < 2 * BN;
    const int bc = n0 + (tid >> 1);
    auto load = [&](int stage, int kt) {
      const int kk = kt * kBK + half * 16;
      const int tap = kk / p.C, c = kk - tap * p.C;
      const int kh = tap / p.k, kw = tap - kh * p.k;
      const int hi = hi0 + kh, wi = wi0 + kw;
      const bool ok = m < p.M && kk < p.K && hi >= 0 && hi < p.H && wi >= 0 &&
                      wi < p.W;
      const int8_t* src =
          ok ? p.x + (((long long)an * p.H + hi) * p.W + wi) * p.C + c : p.x;
      cp_async16(&As[stage][ar * kRow + half * 16], src, ok);
      if (b_thread) {
        const bool okb = bc < p.O && kk < p.K;
        const int8_t* wsrc = okb ? p.w + (long long)bc * p.K + kk : p.w;
        cp_async16(&Bs[stage][(tid >> 1) * kRow + half * 16], wsrc, okb);
      }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < ktiles) load(s, s);
      cp_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      cp_wait<STAGES - 2>();
      __syncthreads();
      const int nk = kt + STAGES - 1;
      if (nk < ktiles) load(nk % STAGES, nk);
      cp_commit();
      tile_mma<NI>(As[kt % STAGES], Bs[kt % STAGES], wm, wn, lane, acc);
    }
  } else {
    for (int kt = 0; kt < ktiles; ++kt) {
      for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
        const int r = idx >> 5, kl = idx & 31;
        As[0][r * kRow + kl] = a_byte(p, m0 + r, kt * kBK + kl);
      }
      for (int idx = tid; idx < BN * kBK; idx += kThreads) {
        const int r = idx >> 5, kl = idx & 31;
        const int col = n0 + r, kk = kt * kBK + kl;
        Bs[0][r * kRow + kl] =
            (col < p.O && kk < p.K) ? p.w[(long long)col * p.K + kk] : 0;
      }
      __syncthreads();
      tile_mma<NI>(As[0], Bs[0], wm, wn, lane, acc);
      __syncthreads();
    }
  }

  // epilogue: f32(acc) * (row_scale * col_scale)
  const int g = lane >> 2, t = lane & 3;
  const int hw = p.Ho * p.Wo;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm * 64 + mi * 16 + g + h * 8;
      if (row >= p.M) continue;
      const float rs = p.rs[p.per_sample ? (int)(row / hw) : 0];
      float* orow = p.out + row * p.O;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = n0 + wn * NI * 8 + ni * 8 + t * 2;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (col + j < p.O)
            orow[col + j] =
                __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + j]),
                          __fmul_rn(rs, p.cs[col + j]));
        }
      }
    }
  }
}

template <int BN>
int launch(const Conv& p, bool vec, cudaStream_t st) {
  dim3 grid((unsigned)((p.M + kBM - 1) / kBM), (unsigned)((p.O + BN - 1) / BN));
  if (vec)
    qconv_kernel<BN, true><<<grid, kThreads, 0, st>>>(p);
  else
    qconv_kernel<BN, false><<<grid, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, H, W, C) s8; w: (O, k, k, C) s8; rs: 1 or N f32 (per_sample);
// cs: O f32; out: (N, Ho, Wo, O) f32 with Ho = (H + 2 pad - k) / stride + 1.
// Returns the CUDA error code of the launch.
extern "C" int coin_qconv(const void* x, const void* w, const float* rs,
                          const float* cs, void* out, int N, int H, int W,
                          int C, int O, int k, int stride, int pad,
                          int per_sample, void* stream) {
  Conv p;
  p.x = (const int8_t*)x;
  p.w = (const int8_t*)w;
  p.rs = rs;
  p.cs = cs;
  p.out = (float*)out;
  p.N = N; p.H = H; p.W = W; p.C = C; p.O = O; p.k = k;
  p.stride = stride; p.pad = pad; p.per_sample = per_sample;
  p.Ho = (H + 2 * pad - k) / stride + 1;
  p.Wo = (W + 2 * pad - k) / stride + 1;
  p.K = k * k * C;
  p.M = (long long)N * p.Ho * p.Wo;
  if (p.M <= 0 || O <= 0 || p.K <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = C % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)w % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return O <= 64 ? launch<64>(p, vec, st) : launch<128>(p, vec, st);
}
