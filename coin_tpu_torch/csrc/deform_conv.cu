// K8 · modulated deformable 3x3 convolution (DCNv2) for Hopper, forward
// only (the GLIP cloud teacher runs for inference alone).
//
// Replaces: coin_tpu/models/glip.py:51 `deform_conv3x3`, which the JAX
// package writes as 9 taps x 4 `take_along_axis` gathers of the flattened
// feature map, each tap's samples then multiplied by its mask and its
// (Cin, Cout) slice of the kernel in an einsum summed in f32.
//
// Input: x (B, H, W, Cin) f32; offsets (B, Ho, Wo, 18) f32, (dy, dx) per
// tap; mask (B, Ho, Wo, 9) f32, already through its sigmoid; weight
// (9, Cin, Cout) f32, the HWIO kernel with its two spatial axes merged;
// bias (Cout,) f32 or null. Output (B, Ho, Wo, Cout) f32. Cin a multiple
// of 32, Cout of 128; stride 1 or 2.
//
// Computes, per output position (b, i, j) and tap k = 3 (ky + 1) + kx + 1,
// in JAX's order (glip.py:66-95): py = (i stride + ky) + dy, px likewise;
// the corners floor(py) and floor(py) + 1 (x alike) weigh (1-fy)(1-fx),
// (1-fy)fx, fy(1-fx), fy fx, each zeroed where the corner lies outside
// [0, H) x [0, W) (the test on the float coordinates; the index is
// clipped); the four corner terms summed in the order 00, 01, 10, 11,
// then multiplied by the mask. Explicitly rounded intrinsics keep nvcc
// from contracting those into FMAs, so every sample has the plain
// version's bits. Then out = sum over taps and input channels of
// sample x weight, in f32 FMAs (another order than the einsum's: about
// 1e-6 of the output's scale), plus the bias.
//
// Bound: at GLIP-L's P3 mid call (4 x 76 x 152 positions, 256 -> 256)
// the function moves about 100 MB (47 MB of x, 47 MB out) but does
// 2 x 9 x 256 x 256 operations per position, 54 GFLOP: 0.81 ms on the
// f32 CUDA cores (67 TFLOP/s) against 0.03 ms of memory, so it is bound
// by operations (13 ms per GLIP-L forward of 104 calls). Design: a tiled
// f32 GEMM whose A operand is gathered. One block of 256 threads computes
// 128 positions x 128 output channels, 8 x 8 per thread in registers. Per
// tap, the first 128 threads compute each position's four clipped corner
// offsets and weights once, into shared memory; then, per chunk of 32
// input channels, each warp builds the modulated samples of 16 positions
// (one lane per channel, so a corner's 32 channels are one 128-byte
// load) into a shared tile, the block stages the tap's 32 x 128 weight
// tile, and every thread does 32 x 64 FMAs from shared memory. The
// product stays inside this kernel: no cuBLAS, no im2col in device
// memory. A call with few output tiles (the coarse levels P5-P7: one to a
// few dozen blocks, each taking the same time as a P3 block) splits the
// 72 (tap, channel chunk) steps of its sum over `splits` blocks per tile
// (blockIdx.z), which write f32 partial sums to a scratch buffer; a
// second kernel adds them in split order and adds the bias, so the result
// does not depend on the schedule. Tensor cores (TF32, bf16) would change
// the f32 arithmetic that JAX does, so they are left to a later version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;           // output positions per block
constexpr int kBN = 128;           // output channels per block
constexpr int kBK = 32;            // input channels per chunk
constexpr int kLdA = kBK + 2;      // sample tile row (8-byte aligned)

// out: (B Ho Wo, Cout) with the bias when gridDim.z == 1, else split z's
// partial sum (no bias) at out + z B Ho Wo Cout
__global__ void __launch_bounds__(kThreads, 2)
deform_conv_kernel(const float* __restrict__ x,
                   const float* __restrict__ offsets,
                   const float* __restrict__ mask,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int B, int H, int W, int Cin, int Ho, int Wo, int Cout,
                   int stride) {
  __shared__ __align__(16) float As[kBM * kLdA];   // [position][channel]
  __shared__ __align__(16) float Bs[kBK * kBN];    // [channel][out channel]
  __shared__ int corner_idx[4][kBM];               // (b H + y) W + x
  __shared__ float corner_w[4][kBM];               // 0 outside the map
  __shared__ float modulation[kBM];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;          // 16 x 16 threads
  const int hw_out = Ho * Wo;
  const long long M = (long long)B * hw_out;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  const int chunks = Cin / kBK;
  const int steps = 9 * chunks / gridDim.z;        // (tap, chunk) steps
  const int first = blockIdx.z * steps;
  for (int step = first; step < first + steps; ++step) {
    const int tap = step / chunks, c0 = step % chunks * kBK;
    if ((c0 == 0 || step == first) && tid < kBM) {   // a new tap
      const long long m = m0 + tid;
      if (m < M) {
        const int b = (int)(m / hw_out);
        const int r = (int)(m % hw_out);
        const int i = r / Wo, j = r % Wo;
        const float dy = offsets[m * 18 + 2 * tap];
        const float dx = offsets[m * 18 + 2 * tap + 1];
        const float py = __fadd_rn((float)(i * stride + tap / 3 - 1), dy);
        const float px = __fadd_rn((float)(j * stride + tap % 3 - 1), dx);
        const float y0 = floorf(py), x0 = floorf(px);
        const float fy = __fsub_rn(py, y0), fx = __fsub_rn(px, x0);
        const float cy[2] = {y0, __fadd_rn(y0, 1.0f)};
        const float cx[2] = {x0, __fadd_rn(x0, 1.0f)};
        const float wy[2] = {__fsub_rn(1.0f, fy), fy};
        const float wx[2] = {__fsub_rn(1.0f, fx), fx};
        const float fh = (float)H, fw = (float)W;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float yy = cy[c >> 1], xx = cx[c & 1];
          const bool inside = yy >= 0.0f && yy < fh && xx >= 0.0f && xx < fw;
          const int iy = (int)fminf(fmaxf(yy, 0.0f), fh - 1.0f);
          const int ix = (int)fminf(fmaxf(xx, 0.0f), fw - 1.0f);
          corner_idx[c][tid] = (b * H + iy) * W + ix;
          corner_w[c][tid] = inside ? __fmul_rn(wy[c >> 1], wx[c & 1]) : 0.0f;
        }
        modulation[tid] = mask[m * 9 + tap];
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          corner_idx[c][tid] = 0;
          corner_w[c][tid] = 0.0f;
        }
        modulation[tid] = 0.0f;
      }
    }
    __syncthreads();
    // the modulated samples: lane = input channel, 16 positions a warp
    const float* xc = x + c0 + lane;
    for (int p = warp; p < kBM; p += kThreads / 32) {
      const float v0 = xc[(size_t)corner_idx[0][p] * Cin];
      const float v1 = xc[(size_t)corner_idx[1][p] * Cin];
      const float v2 = xc[(size_t)corner_idx[2][p] * Cin];
      const float v3 = xc[(size_t)corner_idx[3][p] * Cin];
      float s = __fmul_rn(v0, corner_w[0][p]);
      s = __fadd_rn(s, __fmul_rn(v1, corner_w[1][p]));
      s = __fadd_rn(s, __fmul_rn(v2, corner_w[2][p]));
      s = __fadd_rn(s, __fmul_rn(v3, corner_w[3][p]));
      As[p * kLdA + lane] = __fmul_rn(s, modulation[p]);
    }
    // the tap's weight tile: 32 input x 128 output channels
    const float* wt = weight + ((size_t)tap * Cin + c0) * Cout + n0;
    for (int q = tid; q < kBK * kBN / 4; q += kThreads) {
      const int k = q / (kBN / 4), n4 = q % (kBN / 4);
      reinterpret_cast<float4*>(Bs)[q] =
          reinterpret_cast<const float4*>(wt + (size_t)k * Cout)[n4];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBK; k += 2) {
      float bv[2][8];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float4 lo =
            reinterpret_cast<const float4*>(Bs + (k + kk) * kBN)[tx];
        const float4 hi =
            reinterpret_cast<const float4*>(Bs + (k + kk) * kBN + 64)[tx];
        bv[kk][0] = lo.x; bv[kk][1] = lo.y; bv[kk][2] = lo.z;
        bv[kk][3] = lo.w; bv[kk][4] = hi.x; bv[kk][5] = hi.y;
        bv[kk][6] = hi.z; bv[kk][7] = hi.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 a =
            *reinterpret_cast<const float2*>(As + (ty * 8 + i) * kLdA + k);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a.x, bv[0][j], acc[i][j]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a.y, bv[1][j], acc[i][j]);
      }
    }
    __syncthreads();                 // the tiles are consumed
  }

  const bool add_bias = bias != nullptr && gridDim.z == 1;
  out += (size_t)blockIdx.z * M * Cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tx * 4;
      float4 r = make_float4(acc[i][half * 4], acc[i][half * 4 + 1],
                             acc[i][half * 4 + 2], acc[i][half * 4 + 3]);
      if (add_bias) {
        r.x = __fadd_rn(r.x, bias[n]);
        r.y = __fadd_rn(r.y, bias[n + 1]);
        r.z = __fadd_rn(r.z, bias[n + 2]);
        r.w = __fadd_rn(r.w, bias[n + 3]);
      }
      *reinterpret_cast<float4*>(out + m * Cout + n) = r;
    }
  }
}

// out = (partial[0] + partial[1] + ... + partial[splits - 1]) + bias, in
// that order, four values a thread
__global__ void __launch_bounds__(kThreads)
deform_conv_reduce(const float4* __restrict__ partial,
                   const float* __restrict__ bias, float4* __restrict__ out,
                   long long n4, int cout4, int splits) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  float4 acc = partial[i];
  for (int z = 1; z < splits; ++z) {
    const float4 p = partial[(size_t)z * n4 + i];
    acc.x = __fadd_rn(acc.x, p.x);
    acc.y = __fadd_rn(acc.y, p.y);
    acc.z = __fadd_rn(acc.z, p.z);
    acc.w = __fadd_rn(acc.w, p.w);
  }
  if (bias != nullptr) {
    const float4 b = reinterpret_cast<const float4*>(bias)[i % cout4];
    acc.x = __fadd_rn(acc.x, b.x);
    acc.y = __fadd_rn(acc.y, b.y);
    acc.z = __fadd_rn(acc.z, b.z);
    acc.w = __fadd_rn(acc.w, b.w);
  }
  out[i] = acc;
}

}  // namespace

// x: (B, H, W, Cin); offsets: (B, Ho, Wo, 18); mask: (B, Ho, Wo, 9);
// weight: (9, Cin, Cout); bias: (Cout,) or null; out: (B, Ho, Wo, Cout);
// all f32, contiguous, 16-byte aligned. splits divides 9 Cin / 32; when it
// is above 1, partial is scratch of (splits, B, Ho, Wo, Cout) f32. Returns
// the CUDA error code of the launches (0 on success).
extern "C" int coin_deform_conv(const void* x, const void* offsets,
                                const void* mask, const void* weight,
                                const void* bias, void* out, void* partial,
                                int B, int H, int W, int Cin, int Ho, int Wo,
                                int Cout, int stride, int splits,
                                void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || Cin <= 0 ||
      Cout <= 0 || Cin % kBK || Cout % kBN || (stride != 1 && stride != 2) ||
      splits <= 0 || (9 * Cin / kBK) % splits ||
      (splits > 1 && partial == nullptr) ||
      (long long)B * H * W >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long M = (long long)B * Ho * Wo;
  const long long blocks = (M + kBM - 1) / kBM;
  if (blocks > 2147483647LL || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)blocks, (unsigned)(Cout / kBN), (unsigned)splits);
  deform_conv_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)x, (const float*)offsets, (const float*)mask,
      (const float*)weight, (const float*)bias,
      (float*)(splits > 1 ? partial : out), B, H, W, Cin, Ho, Wo, Cout,
      stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n4 = M * Cout / 4;
  deform_conv_reduce<<<(unsigned)((n4 + kThreads - 1) / kThreads), kThreads,
                       0, s>>>((const float4*)partial, (const float*)bias,
                               (float4*)out, n4, Cout / 4, splits);
  return (int)cudaGetLastError();
}
