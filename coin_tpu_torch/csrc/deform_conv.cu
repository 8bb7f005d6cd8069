// K8 · modulated deformable 3x3 convolution (DCNv2) for Hopper, forward
// only (the GLIP cloud teacher runs for inference alone).
//
// Replaces: coin_tpu/models/glip.py:51 `deform_conv3x3`, which the JAX
// package writes as 9 taps x 4 `take_along_axis` gathers of the flattened
// feature map, each tap's samples then multiplied by its mask and its
// (Cin, Cout) slice of the kernel in an einsum summed in f32.
//
// Input: x (B, H, W, Cin) f32; offsets (B, Ho, Wo, 18) f32, (dy, dx) per
// tap; mask (B, Ho, Wo, 9) f32, already through its sigmoid; the kernel
// split into TF32 parts (below), hi and lo, each (9, Cout, Cin) f32; bias
// (Cout,) f32 or null. Output (B, Ho, Wo, Cout) f32. Cin a multiple of 32,
// Cout of 128; stride 1 or 2.
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
// sample x weight, plus the bias.
//
// The products run on the tensor cores in 3xTF32: each f32 operand is split
// as a = a_hi + a_lo, a_hi = a rounded to TF32 (10 mantissa bits, to
// nearest, ties away, as cvt.rna does), a_lo = a - a_hi (exact) rounded
// the same way, and each K step's a_lo b_hi + a_hi b_lo + a_hi b_hi go
// into a zeroed tensor-core accumulator that is then added to the
// thread's running sum in IEEE f32 (a_lo b_lo, about 2**-22 of a product,
// is left out). A numpy emulation at GLIP's reduction length (K = 9 x 256, M =
// 2048, N = 256) put the error at 7.9e-8 of max |out| with the products
// summed exactly, 6.2e-7 with an f32 sum per k8 step, against 3.9e-7 for an
// f32 SGEMM and 2.8e-4 for one TF32 pass; the kernel is held to 1e-5.
//
// Bound: at GLIP-L's P3 mid call (4 x 76 x 152 positions, 256 -> 256) the
// function moves about 100 MB (47 MB of x, 47 MB out) but does
// 2 x 9 x 256 x 256 operations per position, 54 GFLOP: 0.81 ms on the f32
// CUDA cores (67 TFLOP/s), 0.33 ms as three TF32 passes at 494.7 TFLOP/s,
// against 0.03 ms of memory, so it is bound by operations.
//
// Design: an implicit GEMM on wgmma.m64n128k8.f32.tf32.tf32, M = positions,
// N = Cout (128 columns a block), K = (tap, input channel) in steps of 32
// channels of one tap (128 bytes of TF32, under the 128-byte swizzle). Two
// warpgroups of 64 rows each. At each tap the block computes its 128
// positions' four clipped corner offsets, their weights and the mask once,
// into shared memory. A K step's operands fill one of three 64 KB stages:
// the weights' hi and lo tiles (laid out K-major by `split_weights_kernel`,
// once per weight tensor) by 16-byte cp.async, and the modulated samples, gathered by
// all 256 threads (8 a row, a 16-byte load per corner, 16 loads in flight
// a thread), split into hi and lo and stored into the swizzled A tiles.
// While a step's 12 wgmma run, the threads fill the stage two steps ahead,
// then wait for the products, add them to their sums and meet at one
// barrier a step. The sum is kept out of the tensor cores because their
// f32 accumulation truncates, and its bias grows with the running sum. A
// 256-column block would gather each sample once instead of twice, but its
// two accumulators would need 256 registers a thread. A call with few
// output tiles (the coarse levels P4-P7) splits the 9 Cin / 32 K steps of
// its sum over `splits` blocks per tile (blockIdx.z), which write f32
// partial sums to a scratch buffer; a second kernel adds them in split
// order and adds the bias, so the result does not depend on the schedule.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // two warpgroups
constexpr int kBM = 128;           // output positions per block
constexpr int kBK = 32;            // input channels per K step (128 bytes)
constexpr int kRow = kBK * 4;      // bytes of a tile row
constexpr int kTileA = kBM * kRow; // one A part (hi or lo): 16 KB

constexpr int kBN = 128;           // output channels per block
constexpr int kTileB = kBN * kRow; // one B part (hi or lo): 16 KB
constexpr int kStage = 2 * kTileA + 2 * kTileB;
constexpr int kTable = kBM * 48;   // a tap's corners, weights and mask
constexpr int kStages = 3;         // the fill runs two steps ahead
constexpr int kSmem = kStages * kStage + kTable + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a rounded to TF32: to nearest, ties away from zero (its low 13 bits 0)
__device__ __forceinline__ float tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

// K-major operand, rows of 128 bytes, 128-byte swizzle: 8-row groups 1024
// bytes apart (SBO); the leading offset is unused in this layout. Logical
// 16-byte chunk c of row r lies at chunk c ^ (r % 8) of the row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128 f32 of the warpgroup) = A (64 x 8 tf32) * B (128 x 8 tf32)^T
// + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}
#undef D8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across a wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) asm volatile("" : "+f"(d[j])::"memory");
}

// hi[t][n][c] = tf32(w[t][c][n]), lo = tf32(w - hi): the kernel's HWIO
// slices laid out K-major (input channels innermost) for wgmma
__global__ void __launch_bounds__(256)
split_weights_kernel(const float* __restrict__ w, float* __restrict__ hi,
                     float* __restrict__ lo, int Cin, int Cout) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= 9LL * Cin * Cout) return;
  const int c = (int)(i % Cin);
  const long long tn = i / Cin;
  const int n = (int)(tn % Cout), t = (int)(tn / Cout);
  const float v = w[((long long)t * Cin + c) * Cout + n];
  const float h = tf32(v);
  hi[i] = h;
  lo[i] = tf32(__fsub_rn(v, h));
}

// One tap's view of the block's 128 positions: the four clipped corner
// offsets ((b H + y) W + x), their weights (0 outside the map) and the
// mask.
struct TapTable {
  int4 idx[kBM];
  float4 w[kBM];
  float m[kBM];
};

// The table of `tap` for the block's positions, by threads 0 .. 127
__device__ __forceinline__ void build_table(
    TapTable* table, const float* __restrict__ offsets,
    const float* __restrict__ mask, long long m0, long long M, int tap,
    int H, int W, int Wo, int hw_out, int stride) {
  const int t = threadIdx.x;
  if (t >= kBM) return;
  const long long m = m0 + t;
  int4 ci = make_int4(0, 0, 0, 0);
  float4 cw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float mod = 0.0f;
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
    int ix[4];
    float wt[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float yy = cy[c >> 1], xx = cx[c & 1];
      const bool inside = yy >= 0.0f && yy < fh && xx >= 0.0f && xx < fw;
      const int iy = (int)fminf(fmaxf(yy, 0.0f), fh - 1.0f);
      const int jx = (int)fminf(fmaxf(xx, 0.0f), fw - 1.0f);
      ix[c] = (b * H + iy) * W + jx;
      wt[c] = inside ? __fmul_rn(wy[c >> 1], wx[c & 1]) : 0.0f;
    }
    ci = make_int4(ix[0], ix[1], ix[2], ix[3]);
    cw = make_float4(wt[0], wt[1], wt[2], wt[3]);
    mod = mask[m * 9 + tap];
  }
  table->idx[t] = ci;
  table->w[t] = cw;
  table->m[t] = mod;
}

// One K step's operands into the stage at `sa` (shared address; `stage` its
// generic pointer): the weights' hi and lo tiles by cp.async (one commit
// group), and the modulated samples of the tap's table, split into hi and
// lo, by plain stores. Thread t fills 16-byte piece t % 8 of rows t / 8 +
// 32 i.
__device__ __forceinline__ void fill_stage(
    uint32_t sa, uint8_t* stage, const TapTable* table,
    const float* __restrict__ x, const float* __restrict__ w_hi,
    const float* __restrict__ w_lo, int tap, int c0, int n0, int Cin,
    int Cout) {
  const int t = threadIdx.x, piece = t & 7, r0 = t >> 3;
  constexpr int kRows = kThreads / 8;        // rows a pass covers
  const uint32_t sb = sa + 2 * kTileA;
  const long long wrow = ((long long)tap * Cout + n0) * Cin + c0 + piece * 4;
#pragma unroll
  for (int n = r0; n < kBN; n += kRows) {
    const uint32_t dst = n * kRow + ((piece ^ (n & 7)) << 4);
    cp_async16(sb + dst, w_hi + wrow + (long long)n * Cin);
    cp_async16(sb + kTileB + dst, w_lo + wrow + (long long)n * Cin);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const float* xc = x + c0 + piece * 4;
  constexpr int kPer = kBM / kRows;          // rows a thread fills
  float4 v[kPer][4];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int4 ci = table->idx[r0 + i * kRows];
    v[i][0] = __ldg(reinterpret_cast<const float4*>(xc + (size_t)ci.x * Cin));
    v[i][1] = __ldg(reinterpret_cast<const float4*>(xc + (size_t)ci.y * Cin));
    v[i][2] = __ldg(reinterpret_cast<const float4*>(xc + (size_t)ci.z * Cin));
    v[i][3] = __ldg(reinterpret_cast<const float4*>(xc + (size_t)ci.w * Cin));
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = r0 + i * kRows;
    const float4 cw = table->w[r];
    const float mod = table->m[r];
    const float a0[4] = {v[i][0].x, v[i][0].y, v[i][0].z, v[i][0].w};
    const float a1[4] = {v[i][1].x, v[i][1].y, v[i][1].z, v[i][1].w};
    const float a2[4] = {v[i][2].x, v[i][2].y, v[i][2].z, v[i][2].w};
    const float a3[4] = {v[i][3].x, v[i][3].y, v[i][3].z, v[i][3].w};
    float h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sv = __fmul_rn(a0[e], cw.x);
      sv = __fadd_rn(sv, __fmul_rn(a1[e], cw.y));
      sv = __fadd_rn(sv, __fmul_rn(a2[e], cw.z));
      sv = __fadd_rn(sv, __fmul_rn(a3[e], cw.w));
      sv = __fmul_rn(sv, mod);
      h[e] = tf32(sv);
      l[e] = tf32(__fsub_rn(sv, h[e]));
    }
    const int off = r * kRow + ((piece ^ (r & 7)) << 4);
    *reinterpret_cast<float4*>(stage + off) =
        make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(stage + kTileA + off) =
        make_float4(l[0], l[1], l[2], l[3]);
  }
}

// out: (B Ho Wo, Cout) with the bias when gridDim.z == 1, else split z's
// partial sum (no bias) at out + z B Ho Wo Cout
__global__ void __launch_bounds__(kThreads, 1)
deform_conv_kernel(const float* __restrict__ x,
                   const float* __restrict__ offsets,
                   const float* __restrict__ mask,
                   const float* __restrict__ w_hi,
                   const float* __restrict__ w_lo,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int B, int H, int W, int Cin, int Ho, int Wo, int Cout,
                   int stride) {
  constexpr int S = kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* stages = smem_raw + (base - raw);
  TapTable* table = reinterpret_cast<TapTable*>(stages + S * kStage);

  const int hw_out = Ho * Wo;
  const long long M = (long long)B * hw_out;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int chunks = Cin / kBK;
  const int steps = 9 * chunks / gridDim.z;      // (tap, chunk) K steps
  const int first = blockIdx.z * steps;

  // fills the stage of step `it`, first the tap's table where it starts
  auto fill = [&](int it) {
    const int step = first + it;
    const int tap = step / chunks, c0 = step % chunks * kBK;
    if (c0 == 0 || it == 0) {
      __syncthreads();                 // the previous tap's table is read
      build_table(table, offsets, mask, m0, M, tap, H, W, Wo, hw_out,
                  stride);
      __syncthreads();
    }
    const int s = it % S;
    fill_stage(base + s * kStage, stages + s * kStage, table, x, w_hi, w_lo,
               tap, c0, n0, Cin, Cout);
  };
  for (int it = 0; it < S - 1 && it < steps; ++it) fill(it);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  fence_proxy_async();   // the stores and copies are read by wgmma
  __syncthreads();

  // warpgroup wg multiplies rows 64 wg .. 64 wg + 63 of the tile. Each K
  // step's 12 products go into d, which starts from zero, and d is then
  // added to acc with IEEE f32 adds: the tensor cores' f32 sum truncates,
  // and carried over all 72 steps it lost 1.65e-5 of max |out| (one
  // accumulator, measured); from zero each step it adds only that step's
  // share. While a step's products run, every thread fills the stage of
  // the step S - 1 ahead, whose last reader finished before the barrier.
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31, wq = (threadIdx.x & 127) >> 5;
  float acc[kBN / 2], d[kBN / 2];
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) acc[j] = 0.0f;
  for (int it = 0; it < steps; ++it) {
    const uint32_t sa = base + (it % S) * kStage + wg * 64 * kRow;
    const uint32_t sb = base + (it % S) * kStage + 2 * kTileA;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const uint64_t ah = desc_sw128(sa + kk * 32);
      const uint64_t al = desc_sw128(sa + kTileA + kk * 32);
      const uint64_t bh = desc_sw128(sb + kk * 32);
      const uint64_t bl = desc_sw128(sb + kTileB + kk * 32);
      wgmma_tf32(d, al, bh, kk);
      wgmma_tf32(d, ah, bl, 1);
      wgmma_tf32(d, ah, bh, 1);
    }
    wgmma_commit();
    if (it + S - 1 < steps) fill(it + S - 1);
    wgmma_wait<0>();
    fence_acc(d);
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) acc[j] = __fadd_rn(acc[j], d[j]);
    // the next step's copies have landed (the group just committed, S - 1
    // steps ahead, may fly on)
    static_assert(S == 3, "the wait below lets one newer group fly");
    if (it + S - 1 < steps) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    fence_proxy_async();
    __syncthreads();
  }

  // acc[4j], acc[4j + 1]: row lane / 4 of the warp's 16, columns 8j + 2
  // (lane % 4) and the next; acc[4j + 2], acc[4j + 3]: the row 8 below
  const bool add_bias = bias != nullptr && gridDim.z == 1;
  out += (size_t)blockIdx.z * M * Cout;
  const long long row = m0 + wg * 64 + wq * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane & 3);
    float2 bv = make_float2(0.0f, 0.0f);
    if (add_bias) bv = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = row + 8 * h;
      if (m >= M) continue;
      float2 r = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (add_bias) {
        r.x = __fadd_rn(r.x, bv.x);
        r.y = __fadd_rn(r.y, bv.y);
      }
      *reinterpret_cast<float2*>(out + m * Cout + n) = r;
    }
  }
}

// out = (partial[0] + partial[1] + ... + partial[splits - 1]) + bias, in
// that order, four values a thread
__global__ void __launch_bounds__(256)
deform_conv_reduce(const float4* __restrict__ partial,
                   const float* __restrict__ bias, float4* __restrict__ out,
                   long long n4, int cout4, int splits) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
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

int launch(const void* x, const void* offsets, const void* mask,
           const void* w_hi, const void* w_lo, const void* bias, void* out,
           int B, int H, int W, int Cin, int Ho, int Wo, int Cout, int stride,
           long long blocks, int splits, cudaStream_t s) {
  // once per device: the attribute is not a stream operation, and a launch
  // may be captured into a CUDA graph
  static unsigned long long ready = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && !(ready >> dev & 1)) {
    err = cudaFuncSetAttribute(deform_conv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return (int)err;
    ready |= 1ull << dev;
  }
  dim3 grid((unsigned)blocks, (unsigned)(Cout / kBN), (unsigned)splits);
  deform_conv_kernel<<<grid, kThreads, kSmem, s>>>(
      (const float*)x, (const float*)offsets, (const float*)mask,
      (const float*)w_hi, (const float*)w_lo, (const float*)bias,
      (float*)out, B, H, W, Cin, Ho, Wo, Cout, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// weight: (9, Cin, Cout) f32, the HWIO kernel with its spatial axes merged;
// hi, lo: (9, Cout, Cin) f32, its TF32 parts laid out K-major. Returns the
// CUDA error code of the launch.
extern "C" int coin_deform_conv_split(const void* weight, void* hi, void* lo,
                                      int Cin, int Cout, void* stream) {
  const long long n = 9LL * Cin * Cout;
  if (Cin <= 0 || Cout <= 0 || n >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  split_weights_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(
      (const float*)weight, (float*)hi, (float*)lo, Cin, Cout);
  return (int)cudaGetLastError();
}

// x: (B, H, W, Cin); offsets: (B, Ho, Wo, 18); mask: (B, Ho, Wo, 9);
// w_hi, w_lo: (9, Cout, Cin) from coin_deform_conv_split; bias: (Cout,) or
// null; out: (B, Ho, Wo, Cout); all f32, contiguous, 16-byte aligned.
// splits divides 9 Cin / 32; when it is above 1, partial is scratch of
// (splits, B, Ho, Wo, Cout) f32. Returns the CUDA error code of the
// launches (0 on success).
extern "C" int coin_deform_conv(const void* x, const void* offsets,
                                const void* mask, const void* w_hi,
                                const void* w_lo, const void* bias,
                                void* out, void* partial, int B, int H, int W,
                                int Cin, int Ho, int Wo, int Cout, int stride,
                                int splits, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || Cin <= 0 ||
      Cout <= 0 || Cin % kBK || Cout % 128 || (stride != 1 && stride != 2) ||
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
  void* dst = splits > 1 ? partial : out;
  const int err = launch(x, offsets, mask, w_hi, w_lo, bias, dst, B, H, W,
                         Cin, Ho, Wo, Cout, stride, blocks, splits, s);
  if (err != 0 || splits == 1) return err;
  const long long n4 = M * Cout / 4;
  deform_conv_reduce<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      (const float4*)partial, (const float*)bias, (float4*)out, n4, Cout / 4,
      splits);
  return (int)cudaGetLastError();
}
