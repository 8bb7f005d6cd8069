// K2 wgrad · the s8 weight gradient of a stride-1 'same' convolution.
//
// Replaces: coin_tpu/ops/qconv.py `_vjp_bwd`'s int8 wgrad (:203-208), XLA's
// conv_general_dilated(xq, gq, dimension_numbers=("CHWN", "IHWO", "HWNC"),
// preferred_element_type=int32) then `* (xs * gs)`:
//   dw[o, i, kh, kw] = f32(sum_{n,h,w} xq[n, h+kh-p, w+kw-p, i] * gq[n,h,w,o])
//                      * (xs * gs)
// The s32 sum wraps as XLA's s32 does; integer addition is associative, so
// the split sums below, added with s32 atomics in any order, give exactly
// the same bits on every run.
//
// GEMM view, per tap (kh, kw): D[o][i] = sum_m G[m][o] * X_tap[m][i] over the
// N * H * W positions m (up to 1728 * 196 = 338 688 in res5). Bound:
// operations, 2e12 MACs per step over res5, 2 ms at 1979 TOPS. Design: 128 x
// 128 (o, i) tiles of mma.sync m16n8k32; both operands arrive position-major
// (NHWC), so each thread loads a 4-position x 4-channel square as four
// 32-bit words, transposes its bytes with __byte_perm and stores them
// channel-major into shared memory; the next 32 positions are loaded into
// registers while the tensor cores work on the current ones. The positions
// are split over blocks (blockIdx.z) to fill the card; each block adds its
// tile into an s32 buffer with atomics, and a last pass rescales.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // o
constexpr int kBN = 128;  // i
constexpr int kBK = 32;   // positions
constexpr int kRow = 36;  // bytes per smem row: 32 of data, 4 of padding
constexpr int kThreads = 256;

struct Wgrad {
  const int8_t* x;  // (N, H, W, I)
  const int8_t* g;  // (N, H, W, O)
  int* acc;         // (k * k, O, I)
  int N, H, W, I, O, k, pad, chunk;
  long long M;
};

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

__global__ void __launch_bounds__(kThreads) wgrad_kernel(Wgrad p) {
  __shared__ __align__(16) int8_t As[2][kBM * kRow];
  __shared__ __align__(16) int8_t Bs[2][kBN * kRow];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int tiles_i = (p.I + kBN - 1) / kBN;
  const int o0 = (blockIdx.x / tiles_i) * kBM;
  const int i0 = (blockIdx.x % tiles_i) * kBN;
  const int tap = blockIdx.y;
  const int dh = tap / p.k - p.pad, dw = tap % p.k - p.pad;
  const long long mbeg = (long long)blockIdx.z * p.chunk;
  long long mend = mbeg + p.chunk;
  if (mend > p.M) mend = p.M;
  if (mbeg >= mend) return;
  const int ktiles = (int)((mend - mbeg + kBK - 1) / kBK);
  const int hw = p.H * p.W;

  // this thread's square: positions mq*4 .. +3 of the tile, channels cq*4 ..
  const int mq = tid >> 5, cq = tid & 31;
  const bool o_ok = o0 + cq * 4 < p.O, i_ok = i0 + cq * 4 < p.I;
  uint32_t ga[4], xb[4];
  auto load = [&](int kt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long m = mbeg + (long long)kt * kBK + mq * 4 + r;
      ga[r] = 0;
      xb[r] = 0;
      if (m >= mend) continue;
      if (o_ok)
        ga[r] = *reinterpret_cast<const uint32_t*>(p.g + m * p.O + o0 + cq * 4);
      if (i_ok) {
        const int n = (int)(m / hw);
        const int rem = (int)(m - (long long)n * hw);
        const int h = rem / p.W + dh, w = rem % p.W + dw;
        if (h >= 0 && h < p.H && w >= 0 && w < p.W)
          xb[r] = *reinterpret_cast<const uint32_t*>(
              p.x + (((long long)n * p.H + h) * p.W + w) * p.I + i0 + cq * 4);
      }
    }
  };
  auto store = [&](int buf) {
    uint32_t c[4];
    transpose4(ga, c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(&As[buf][(cq * 4 + j) * kRow + mq * 4]) = c[j];
    transpose4(xb, c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(&Bs[buf][(cq * 4 + j) * kRow + mq * 4]) = c[j];
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  load(0);
  store(0);
  __syncthreads();
  const int g = lane >> 2, t = lane & 3;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < ktiles) load(kt + 1);
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int8_t* r0 = As[buf] + (wm * 64 + mi * 16 + g) * kRow + t * 4;
      const int8_t* r1 = r0 + 8 * kRow;
      a[mi][0] = lds32(r0);
      a[mi][1] = lds32(r1);
      a[mi][2] = lds32(r0 + 16);
      a[mi][3] = lds32(r1 + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* c0 = Bs[buf] + (wn * 32 + ni * 8 + g) * kRow + t * 4;
      b[ni][0] = lds32(c0);
      b[ni][1] = lds32(c0 + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    if (kt + 1 < ktiles) store(buf ^ 1);
    __syncthreads();
  }

  int* out = p.acc + (long long)tap * p.O * p.I;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + wm * 64 + mi * 16 + g + h * 8;
      if (o >= p.O) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = i0 + wn * 32 + ni * 8 + t * 2 + j;
          if (i < p.I) atomicAdd(out + (long long)o * p.I + i, acc[mi][ni][2 * h + j]);
        }
    }
}

// acc (k*k, O, I) s32 -> dw (O, I, k, k) f32 = f32(acc) * (xs * gs)
__global__ void finish_kernel(const int* __restrict__ acc,
                              const float* __restrict__ xs,
                              const float* __restrict__ gs, float* dw, int O,
                              int I, int k) {
  const int kk = k * k;
  const long long n = (long long)O * I * kk;
  const float s = __fmul_rn(xs[0], gs[0]);
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const int tap = (int)(idx % kk);
    const long long oi = idx / kk;
    dw[idx] = __fmul_rn(__int2float_rn(acc[(long long)tap * O * I + oi]), s);
  }
}

}  // namespace

// x: (N, H, W, I) s8, g: (N, H, W, O) s8 (stride 1, padding pad = k / 2);
// xs, gs: one f32 each; acc: k*k*O*I s32 of scratch; dw: (O, I, k, k) f32.
// Needs I and O multiples of 4 and 4-byte aligned tensors. Returns the CUDA
// error code of the launches.
extern "C" int coin_qconv_wgrad(const void* x, const void* g, const float* xs,
                                const float* gs, int* acc, float* dw, int N,
                                int H, int W, int I, int O, int k, int pad,
                                void* stream) {
  if (N <= 0 || I % 4 || O % 4 || (uintptr_t)x % 4 || (uintptr_t)g % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int kk = k * k;
  cudaError_t e = cudaMemsetAsync(acc, 0, sizeof(int) * (size_t)kk * O * I, st);
  if (e != cudaSuccess) return (int)e;
  Wgrad p;
  p.x = (const int8_t*)x;
  p.g = (const int8_t*)g;
  p.acc = acc;
  p.N = N; p.H = H; p.W = W; p.I = I; p.O = O; p.k = k; p.pad = pad;
  p.M = (long long)N * H * W;
  const long long tiles = (long long)((O + kBM - 1) / kBM) * ((I + kBN - 1) / kBN);
  // about four blocks per SM, each over at least 2048 positions
  long long splits = (4 * 132 + tiles * kk - 1) / (tiles * kk);
  const long long most = (p.M + 2047) / 2048;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  long long chunk = (p.M + splits - 1) / splits;
  chunk = (chunk + kBK - 1) / kBK * kBK;
  splits = (p.M + chunk - 1) / chunk;
  p.chunk = (int)chunk;
  dim3 grid((unsigned)tiles, (unsigned)kk, (unsigned)splits);
  wgrad_kernel<<<grid, kThreads, 0, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)O * I * kk;
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  finish_kernel<<<(unsigned)blocks, 256, 0, st>>>(acc, xs, gs, dw, O, I, k);
  return (int)cudaGetLastError();
}
