// K2 forward and dgrad, K2s · s8 x s8 -> s32 convolution over NHWC with an
// f32 rescale, written in f32 or bf16.
//
// Replaces: coin_tpu/ops/qconv.py `_fwd_parts` (:83-98, the forward of
// `int8_train_conv`), the int8 dgrad of `_vjp_bwd` (:184-195) and
// coin_tpu/models/clip_resnet.py `Int8Conv` (:62-92): XLA's
// conv_general_dilated with preferred_element_type=int32, then
//   out = f32(acc) * (row_scale * col_scale)
// with row_scale the activation's (one, or one per sample) and col_scale the
// weight's per output channel, multiplied in exactly that order, then cast to
// the caller's dtype (the modules' `.astype(dtype)`, the dgrad's
// `dx.astype(x_dtype)`): bf16 is the round to nearest even of that f32.
//
// GEMM view: M = N * Ho * Wo output pixels, N' = O channels, K = k * k * C;
// A[m][(kh, kw, c)] = x[n, ho * s - p + kh, wo * s - p + kw, c] (0 outside),
// B[o][(kh, kw, c)] = w (laid out [O][kh][kw][C] by quantize.cu). Both are
// K-major as they lie: a row of A is one tap's C contiguous channels.
//
// Bound: operations for res5 (1728 crops: about 2.0e12 MACs per pass, 2.02
// ms at the 1979 TOPS int8 dense peak; its bf16 output, 2.4 GB, takes 0.73
// ms); bytes for the backbone's narrow convs and the stem.
//
// Two kernels:
// 1. `gemm_kernel<BN>`, for C % 16 == 0 (res5, its dgrad, and every backbone
//    conv past the stem): a persistent implicit GEMM on
//    wgmma.m64nBNk32.s32.s8.s8. A block walks 128 x BN output tiles
//    (BN = 256 for O > 128, 128 for O > 64, else 64); one producer
//    warpgroup fills a ring of stages, each 128 bytes of K = (tap, channel)
//    under the 128-byte swizzle (one tap's 128-channel chunk at C % 128 == 0,
//    several taps' channels for C = 32, 48, 64), and two consumer
//    warpgroups (64 rows each) multiply them. The weights' tile comes by TMA
//    (a 2-D map over (O, K), zeros past either end, every box on 128
//    bytes). The activations' tile is gathered by the producer's 128
//    threads with 16-byte cp.async copies, 128-byte rows read by 8
//    neighbouring threads, into the swizzled layout wgmma reads,
//    zero-filled for the padding, the rows past M and K past its end (C %
//    16 == 0, so no 16 bytes straddle two taps); each thread's copies
//    arrive on the stage's barrier by cp.async.mbarrier.arrive.noinc. This
//    gather, not TMA's im2col mode, feeds A: it takes every stride, padding
//    and channel count through one path, packs the narrow channel counts'
//    taps into full stages, walks the 128 output pixels of a tile across
//    rows and crops (14 x 14 and 7 x 7 crops do not tile 128 rows), and its
//    addresses are plain integer arithmetic that the port's tests can
//    follow. The consumers fence the async proxy after each
//    stage's barrier, since cp.async writes through the generic one.
//    The grid is persistent (one block per SM, two for BN = 64), so the
//    producer fills the ring for the next tile during the epilogue.
//    Epilogue: the consumers write the rescaled tile in the output dtype
//    into swizzled shared-memory boxes, two 128 x 128-byte boxes a round,
//    and one thread stores them with TMA bulk copies that drain while the
//    next tile's main loop runs: the 1 x 1 convs write as many bytes as
//    they read, and stores the warps waited on cost them a third of their
//    time (measured). Rows whose bytes are not a multiple of 16 take a
//    per-warp path instead: 16 rows staged 128 bytes a pass and stored 16
//    bytes a lane. A stalled barrier wait traps after about ten seconds
//    instead of hanging the card.
// 2. `direct_kernel`, for any other channel count (the stem: C = 3, 3 x 3,
//    stride 2, 3 -> 32 at 608 x 1216), bound by its output bytes: a block
//    takes 128 output pixels of one row and 32 output channels, stages the
//    input rows they read (all taps, padding as zeros) and the weights once
//    in shared memory, sums each pixel's k * k * C taps, padded to a
//    multiple of 4, with dp4a (K = 27 is one tensor-core k32 step; dp4a on
//    the CUDA cores does it exactly as well), and writes the output through
//    shared memory with coalesced 16-byte stores. Channel counts that do not
//    fit shared memory at once are summed in chunks.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from cudart
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // output pixels of a GEMM tile
constexpr int kBK = 128;        // bytes of K in a stage
constexpr int kThreads = 384;   // producer warpgroup + two consumers
constexpr int kSmemMax = 232448;
constexpr int kBox = kBM * 128;  // an output box: 128 rows x 128 bytes
constexpr int kStaging = 2 * kBox;  // the epilogue's staging: two boxes
constexpr int kStageRow = 128;  // bytes of a row a warp stages per pass
constexpr int kStagePitch = kStageRow + 32;  // (without TMA stores)
constexpr long long kWatchdogCycles = 20000000000LL;  // about ten seconds
constexpr int kDW = 128;        // output pixels of a direct block
constexpr int kDO = 32;         // output channels of a direct block
constexpr int kEncodeError = 100000;  // + the driver's CUresult

struct Conv {
  const int8_t* x;
  const int8_t* w;
  const float* rs;  // row scales: 1 or N
  const float* cs;  // column scales: O
  void* out;        // f32 or bf16
  int N, H, W, C, O, k, stride, pad, Ho, Wo, K, per_sample, bf16;
  int M;        // output rows, below 2**31 (checked on the host)
  int tma_out;  // output rows a multiple of 16 bytes: TMA-store epilogue
};

template <int BN>
struct Tile {
  // two blocks per SM for the narrowest tile: their main loops and
  // epilogues interleave, and its gather, not its 64-column products,
  // bounds it
  static constexpr int kBlocks = BN == 64 ? 2 : 1;
  static constexpr int kA = kBM * kBK;
  static constexpr int kB = BN * kBK;
  static constexpr int kStage = kA + kB;
  static constexpr int kFit =
      (kSmemMax / kBlocks - 1024 - kStaging - 1024 - 256) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kSmem = kStages * kStage + kStaging + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// spins on the barrier's phase; a wait past about ten seconds traps, so that
// a pipeline fault ends the launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > kWatchdogCycles) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// a box of shared memory to global through the tensor map, in the calling
// thread's bulk group; coordinates off the tensor are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// the 256 consumer threads
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// 16 bytes from global to shared, or 16 zeros when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(pred ? 16 : 0)
               : "memory");
}
// the barrier counts one arrival of this thread once all its earlier
// cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// K-major operand, rows of 128 bytes, 128-byte swizzle: 8-row groups 1024
// bytes apart (SBO); the leading offset is unused in this layout. Logical
// 16-byte chunk c of row r lies at chunk c ^ (r % 8) of the row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define D8(i)                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),          \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 256 s32 of the warpgroup) += A (64 x 32 s8) * B (256 x 32 s8)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64),
        D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 s32 of the warpgroup) += A (64 x 32 s8) * B (64 x 32 s8)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128 s32 of the warpgroup) += A (64 x 32 s8) * B (128 x 32 s8)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(1));
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
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) asm volatile("" : "+r"(d[j])::"memory");
}

// 16 bytes of ES-byte values from shared memory to `dst`: one vector store,
// or the first `n` values one by one at a ragged or unaligned row end
template <int ES>
__device__ __forceinline__ void store16(uint8_t* dst, const uint8_t* src,
                                        int n, bool vec) {
  if (vec && n >= 16 / ES) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    return;
  }
  for (int e = 0; e < 16 / ES && e < n; ++e) {
    if constexpr (ES == 4)
      reinterpret_cast<float*>(dst)[e] = reinterpret_cast<const float*>(src)[e];
    else
      reinterpret_cast<uint16_t*>(dst)[e] =
          reinterpret_cast<const uint16_t*>(src)[e];
  }
}

// One consumer warp's epilogue: its 16 rows (row0 ..) x BN columns (n0 ..)
// of s32 sums in the m64nN accumulator layout (warp w of the warpgroup holds
// rows 16w .. 16w+15; for each 8 columns j, d[4j], d[4j+1] at row lane/4,
// columns 2 (lane%4) + {0, 1}, and d[4j+2], d[4j+3] eight rows below),
// rescaled and rounded to ES-byte values, 128 bytes of columns a pass through
// the warp's staging rows, then stored 16 bytes a lane, 4 rows of 128
// contiguous bytes per store.
template <int BN, int ES>
__device__ __forceinline__ void epilogue(const Conv& p, const int (&d)[BN / 2],
                                         int row0, int n0, int lane,
                                         uint8_t* buf, bool vec) {
  constexpr int CP = kStageRow / ES;  // columns of a pass
  constexpr int JP = CP / 8;          // 8-column groups of a pass
  constexpr int PITCH = kStageRow + (ES == 4 ? 32 : 16);  // no bank conflict
  const int g = lane >> 2, t = lane & 3;
  const int hw = p.Ho * p.Wo;
  float rsv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    rsv[h] = row < p.M ? p.rs[p.per_sample ? row / hw : 0] : 0.f;
  }
#pragma unroll
  for (int ps = 0; ps < BN / CP; ++ps) {
#pragma unroll
    for (int jj = 0; jj < JP; ++jj) {
      const int j = ps * JP + jj;
      const int col = n0 + j * 8 + 2 * t;
      const float c0 = col < p.O ? p.cs[col] : 0.f;
      const float c1 = col + 1 < p.O ? p.cs[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = __fmul_rn(__int2float_rn(d[4 * j + 2 * h]),
                                   __fmul_rn(rsv[h], c0));
        const float v1 = __fmul_rn(__int2float_rn(d[4 * j + 2 * h + 1]),
                                   __fmul_rn(rsv[h], c1));
        uint8_t* dst = buf + (g + 8 * h) * PITCH + (jj * 8 + 2 * t) * ES;
        if constexpr (ES == 4)
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int chunk = q * 32 + lane, r = chunk >> 3, c16 = chunk & 7;
      const int row = row0 + r;
      const int col = n0 + ps * CP + c16 * (16 / ES);
      if (row < p.M && col < p.O)
        store16<ES>(static_cast<uint8_t*>(p.out) +
                        ((long long)row * p.O + col) * ES,
                    buf + r * PITCH + c16 * 16, p.O - col, vec);
    }
    __syncwarp();
  }
}

// The tile's epilogue through TMA stores: the two consumer warpgroups write
// the rescaled values, 256 bytes of columns a round, into two 128-row x
// 128-byte boxes under the 128-byte swizzle (no bank conflict in bf16), and
// one thread (`issuer`) stores the boxes with bulk tensor copies that drain
// while the next tile's main loop runs; TMA clips the rows past M and the
// columns past O. `rloc` is the thread's warp's first row in the tile.
template <int BN, int ES>
__device__ __forceinline__ void epilogue_tma(const Conv& p,
                                             const CUtensorMap* omap,
                                             const int (&d)[BN / 2], int m0,
                                             int n0, int rloc, int lane,
                                             uint8_t* stage, bool issuer) {
  constexpr int GB = 16 / ES;  // 8-column groups of a box
  constexpr int GR = 2 * GB;   // groups of a round
  constexpr int ROUNDS = (BN / 8 + GR - 1) / GR;
  const int g = lane >> 2, t = lane & 3;
  const int hw = p.Ho * p.Wo;
  const uint32_t sbase = smem_u32(stage);
  float rsv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + rloc + g + 8 * h;
    rsv[h] = row < p.M ? p.rs[p.per_sample ? row / hw : 0] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    if (issuer) bulk_wait_read();
    consumer_sync();  // the boxes are free
#pragma unroll
    for (int jr = 0; jr < GR; ++jr) {
      const int j = r * GR + jr;
      if (j >= BN / 8) break;
      const int col = n0 + j * 8 + 2 * t;
      const float c0 = col < p.O ? p.cs[col] : 0.f;
      const float c1 = col + 1 < p.O ? p.cs[col + 1] : 0.f;
      const int cb = ((jr % GB) * 8 + 2 * t) * ES;  // byte in the box row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = __fmul_rn(__int2float_rn(d[4 * j + 2 * h]),
                                   __fmul_rn(rsv[h], c0));
        const float v1 = __fmul_rn(__int2float_rn(d[4 * j + 2 * h + 1]),
                                   __fmul_rn(rsv[h], c1));
        const int row = rloc + g + 8 * h;
        uint8_t* dst = stage + (jr / GB) * kBox + row * 128 +
                       (((cb >> 4) ^ (row & 7)) << 4) + (cb & 15);
        if constexpr (ES == 4)
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
    fence_proxy_async();  // the boxes, written here, are read by TMA
    consumer_sync();
    if (issuer) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int col = n0 + (r * 2 + b) * (128 / ES);
        if (col < n0 + BN) tma_store(omap, sbase + b * kBox, col, m0);
      }
      bulk_commit();
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, Tile<BN>::kBlocks)
    gemm_kernel(const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap omap, Conv p,
                int tiles_n, int tiles) {
  using T = Tile<BN>;
  constexpr int S = T::kStages;
  constexpr int P = kBK / 16;  // 16-byte pieces of a stage's row
  constexpr int RS = kBM / P;  // rows between a producer thread's rows
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int nk = (p.K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&full[s]), kBM + 1);  // 128 gathers + the TMA's
      mbar_init(smem_u32(&empty[s]), 2);       // one per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // producer: thread t gathers piece t % P of rows t / P + i RS
    const int t = threadIdx.x, piece = t % P, r0 = t / P;
    const int hw = p.Ho * p.Wo;
    uint32_t dst[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int r = r0 + i * RS;
      dst[i] = r * kBK + ((piece ^ (r & 7)) << 4);
    }
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kBM;
      const int n0 = (tile % tiles_n) * BN;
      const int8_t* img[P];
      int hi0[P], wi0[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int m = m0 + r0 + i * RS;
        if (m < p.M) {
          const int n = m / hw, rem = m - n * hw;
          const int ho = rem / p.Wo, wo = rem - ho * p.Wo;
          img[i] = p.x + (long long)n * p.H * p.W * p.C;
          hi0[i] = ho * p.stride - p.pad;
          wi0[i] = wo * p.stride - p.pad;
        } else {  // past M: every tap reads zeros
          img[i] = p.x;
          hi0[i] = -(1 << 28);
          wi0[i] = 0;
        }
      }
      // this thread's piece of the stage: K byte q = (tap, channel c)
      int q = piece * 16, tap = q / p.C, c = q - tap * p.C;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(smem_u32(&empty[s]), ((it / S) + 1) & 1);
        const int kh = tap / p.k, kw = tap - kh * p.k;
        const bool cok = q < p.K;
        const uint32_t sa = base + s * T::kStage;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const int hi = hi0[i] + kh, wi = wi0[i] + kw;
          const bool ok = cok && (unsigned)hi < (unsigned)p.H &&
                          (unsigned)wi < (unsigned)p.W;
          const int8_t* src =
              ok ? img[i] + ((long long)hi * p.W + wi) * p.C + c : p.x;
          cp_async16(sa + dst[i], src, ok);
        }
        const uint32_t fb = smem_u32(&full[s]);
        cp_async_arrive(fb);
        if (t == 0) {
          mbar_expect_tx(fb, T::kB);
          tma_load(sa + T::kA, &wmap, kt * kBK, n0, fb);
        }
        q += kBK;
        for (c += kBK; c >= p.C; c -= p.C) ++tap;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumers: warpgroup cw multiplies rows 64 cw .. 64 cw + 63 of the tile
  const int cw = wg - 1;
  const int lane = threadIdx.x & 31, w = (threadIdx.x & 127) >> 5;
  uint8_t* stage = smem_raw + (base - raw) + S * T::kStage;
  uint8_t* buf = stage + (cw * 4 + w) * 16 * kStagePitch;
  const bool issuer = threadIdx.x == 128;
  const int es = p.bf16 ? 2 : 4;
  const bool vec = (p.O * es) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  int d[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * kBM;
    const int n0 = (tile % tiles_n) * BN;
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) d[j] = 0;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(smem_u32(&full[s]), (it / S) & 1);
      fence_proxy_async();  // the gathered A tile was written by cp.async
      const uint32_t sa = base + s * T::kStage + cw * 64 * kBK;
      const uint32_t sb = base + s * T::kStage + T::kA;
      // past K both tiles hold zeros: a last stage that ends early adds 0
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < kBK / 32; ++kq)
        wgmma_s8(d, desc_sw128(sa + kq * 32), desc_sw128(sb + kq * 32));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(d);
      if (kt > 0 && (threadIdx.x & 127) == 0)
        mbar_arrive(smem_u32(&empty[(it - 1) % S]));
    }
    wgmma_wait<0>();
    fence_acc(d);
    if ((threadIdx.x & 127) == 0) mbar_arrive(smem_u32(&empty[(it - 1) % S]));
    const int rloc = cw * 64 + w * 16;
    if (p.tma_out) {
      if (p.bf16)
        epilogue_tma<BN, 2>(p, &omap, d, m0, n0, rloc, lane, stage, issuer);
      else
        epilogue_tma<BN, 4>(p, &omap, d, m0, n0, rloc, lane, stage, issuer);
    } else if (p.bf16) {
      epilogue<BN, 2>(p, d, m0 + rloc, n0, lane, buf, vec);
    } else {
      epilogue<BN, 4>(p, d, m0 + rloc, n0, lane, buf, vec);
    }
  }
  if (issuer) bulk_wait();
}

// Shared memory of a direct block: the input patch (k rows of PW pixels of
// cc channels, PW = (kDW - 1) stride + k), the patch offset of each of the
// chunk's k k cc taps (4 kw4 ints, -1 past them), the weights as words of 4
// taps (kw4 x kDO) and the output staging (kDW pixels of kDO values).
struct DirectSmem {
  int patch, tab, wts, stage, total;
};

__host__ __device__ inline DirectSmem direct_smem(int k, int stride, int cc,
                                                  int es) {
  const int pw = (kDW - 1) * stride + k;
  const int kw4 = (k * k * cc + 3) / 4;
  DirectSmem s;
  s.patch = 0;
  s.tab = (k * pw * cc + 15) / 16 * 16;
  s.wts = s.tab + kw4 * 4 * 4;
  s.stage = s.wts + kw4 * kDO * 4;
  s.total = s.stage + kDW * (kDO * es + 16);
  return s;
}

template <bool BF16>
__global__ void __launch_bounds__(kDW) direct_kernel(Conv p, int CC) {
  constexpr int ES = BF16 ? 2 : 4;
  constexpr int PITCH = kDO * ES + 16;  // no bank conflict on 16-byte access
  constexpr int CPP = kDO * ES / 16;    // 16-byte chunks of a pixel's values
  extern __shared__ __align__(16) uint8_t dsm[];
  const DirectSmem lay = direct_smem(p.k, p.stride, CC, ES);
  int8_t* patch = reinterpret_cast<int8_t*>(dsm + lay.patch);
  int* tab = reinterpret_cast<int*>(dsm + lay.tab);
  uint32_t* wts = reinterpret_cast<uint32_t*>(dsm + lay.wts);
  uint8_t* stage = dsm + lay.stage;
  const int pw = (kDW - 1) * p.stride + p.k;
  const int row = blockIdx.x;  // n Ho + ho
  const int n = row / p.Ho, ho = row - n * p.Ho;
  const int wo0 = blockIdx.y * kDW, o0 = blockIdx.z * kDO;
  const int j = threadIdx.x;

  int acc[kDO];
#pragma unroll
  for (int o = 0; o < kDO; ++o) acc[o] = 0;
  for (int c0 = 0; c0 < p.C; c0 += CC) {
    const int cc = min(CC, p.C - c0);
    const int kc = p.k * p.k * cc, kw4 = (kc + 3) / 4;
    __syncthreads();  // the previous chunk is summed
    for (int idx = j; idx < p.k * pw * cc; idx += kDW) {
      const int kh = idx / (pw * cc), rem = idx - kh * pw * cc;
      const int col = rem / cc, c = rem - col * cc;
      const int hi = ho * p.stride - p.pad + kh;
      const int wi = wo0 * p.stride - p.pad + col;
      patch[idx] = (hi >= 0 && hi < p.H && wi >= 0 && wi < p.W)
                       ? p.x[(((long long)n * p.H + hi) * p.W + wi) * p.C +
                             c0 + c]
                       : 0;
    }
    for (int q = j; q < kw4 * 4; q += kDW) {
      int v = -1;
      if (q < kc) {
        const int tap = q / cc, c = q - tap * cc;
        const int kh = tap / p.k, kw = tap - kh * p.k;
        v = (kh * pw + kw) * cc + c;
      }
      tab[q] = v;
    }
    for (int idx = j; idx < kw4 * kDO; idx += kDW) {
      const int q = idx / kDO, o = idx - q * kDO;
      uint32_t word = 0;
      if (o0 + o < p.O) {
        const int8_t* wrow = p.w + (long long)(o0 + o) * p.K + c0;
        for (int b = 0; b < 4; ++b) {
          const int kk = 4 * q + b;
          if (kk < kc) {
            const int tap = kk / cc, c = kk - tap * cc;
            word |= (uint32_t)(uint8_t)wrow[tap * p.C + c] << (8 * b);
          }
        }
      }
      wts[idx] = word;
    }
    __syncthreads();
    if (wo0 + j < p.Wo) {
      const int8_t* pp = patch + j * p.stride * cc;
      for (int q = 0; q < kw4; ++q) {
        uint32_t a = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int t = tab[4 * q + b];
          if (t >= 0) a |= (uint32_t)(uint8_t)pp[t] << (8 * b);
        }
        const uint32_t* wq = wts + q * kDO;
#pragma unroll
        for (int o = 0; o < kDO; ++o)
          acc[o] = __dp4a((int)a, (int)wq[o], acc[o]);
      }
    }
  }

  // epilogue: f32(acc) * (row_scale * col_scale), rounded to the output type
  const float rs = p.rs[p.per_sample ? n : 0];
  uint8_t* mine = stage + j * PITCH;
#pragma unroll
  for (int q = 0; q < CPP; ++q) {
    float v[16 / ES];
#pragma unroll
    for (int e = 0; e < 16 / ES; ++e) {
      const int o = q * (16 / ES) + e, col = o0 + o;
      v[e] = col < p.O
                 ? __fmul_rn(__int2float_rn(acc[o]), __fmul_rn(rs, p.cs[col]))
                 : 0.f;
    }
    uint4 word;
    if constexpr (ES == 4) {
      word = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                        __float_as_uint(v[2]), __float_as_uint(v[3]));
    } else {
      uint32_t h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 b2 = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        h[e] = *reinterpret_cast<const uint32_t*>(&b2);
      }
      word = make_uint4(h[0], h[1], h[2], h[3]);
    }
    *reinterpret_cast<uint4*>(mine + q * 16) = word;
  }
  __syncthreads();
  const bool vec = (p.O * ES) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  for (int idx = j; idx < kDW * CPP; idx += kDW) {
    const int pix = idx / CPP, c16 = idx - pix * CPP;
    const int wo = wo0 + pix, col = o0 + c16 * (16 / ES);
    if (wo < p.Wo && col < p.O)
      store16<ES>(static_cast<uint8_t*>(p.out) +
                      (((long long)row * p.Wo + wo) * p.O + col) * ES,
                  stage + pix * PITCH + c16 * 16, p.O - col, vec);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// the weights (O, K) s8 with a box of 128 bytes x BN rows under the 128-byte
// swizzle; coordinates off the tensor read as zeros
template <int BN>
CUresult encode(CUtensorMap* map, const void* w, int K, int O) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)O};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)BN};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// the output (M, O) in f32 or bf16 with a box of 128 rows x 128 bytes under
// the 128-byte swizzle, for the epilogue's TMA stores
CUresult encode_out(CUtensorMap* map, void* out, int M, int O, bool bf16) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const int es = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)O, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)O * es};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / es), (cuuint32_t)kBM};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            2, out, dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

// raises a kernel's dynamic shared memory limit to `bytes` once per device
// (every later launch must ask for no more)
template <typename F>
cudaError_t allow_smem(F* kernel, int bytes, unsigned* done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && (*done >> dev) & 1u) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 32) *done |= 1u << dev;
  return e;
}

template <int BN>
int launch_gemm(Conv p, cudaStream_t st) {
  using T = Tile<BN>;
  static unsigned done = 0;
  CUtensorMap wmap, omap = {};
  CUresult r = encode<BN>(&wmap, p.w, p.K, p.O);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  p.tma_out = (p.O * (p.bf16 ? 2 : 4)) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  if (p.tma_out) {
    r = encode_out(&omap, p.out, p.M, p.O, p.bf16);
    if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  }
  cudaError_t e = allow_smem(gemm_kernel<BN>, T::kSmem, &done);
  if (e != cudaSuccess) return (int)e;
  const int tiles_n = (p.O + BN - 1) / BN;
  const long long tiles = ((long long)p.M + kBM - 1) / kBM * tiles_n;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int slots = sm_count() * T::kBlocks;
  const int grid = (int)(tiles < slots ? tiles : slots);
  gemm_kernel<BN><<<grid, kThreads, T::kSmem, st>>>(wmap, omap, p, tiles_n,
                                                     (int)tiles);
  return (int)cudaGetLastError();
}

template <bool BF16>
int launch_direct(const Conv& p, cudaStream_t st) {
  static unsigned done = 0;
  const int es = BF16 ? 2 : 4;
  const int pw = (kDW - 1) * p.stride + p.k;
  // the chunk of channels: its patch within 16 KB and its taps within 1024
  const int by_patch = 16384 / (p.k * pw), by_taps = 1024 / (p.k * p.k);
  int cc = p.C < by_patch ? p.C : by_patch;
  if (cc > by_taps) cc = by_taps;
  if (cc < 1) cc = 1;
  const int bytes = direct_smem(p.k, p.stride, cc, es).total;
  if (bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(direct_kernel<BF16>, kSmemMax, &done);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)p.N * p.Ho;
  if (rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)rows, (unsigned)((p.Wo + kDW - 1) / kDW),
            (unsigned)((p.O + kDO - 1) / kDO));
  direct_kernel<BF16><<<grid, kDW, bytes, st>>>(p, cc);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, H, W, C) s8; w: (O, k, k, C) s8; rs: 1 or N f32 (per_sample);
// cs: O f32; out: (N, Ho, Wo, O), f32 or (out_bf16) bf16, with
// Ho = (H + 2 pad - k) / stride + 1. Returns the CUDA error code of the
// launch, or 100000 + the driver's CUresult when it refuses the weights'
// TMA descriptor.
extern "C" int coin_qconv(const void* x, const void* w, const float* rs,
                          const float* cs, void* out, int N, int H, int W,
                          int C, int O, int k, int stride, int pad,
                          int per_sample, int out_bf16, void* stream) {
  Conv p;
  p.x = (const int8_t*)x;
  p.w = (const int8_t*)w;
  p.rs = rs;
  p.cs = cs;
  p.out = out;
  p.N = N; p.H = H; p.W = W; p.C = C; p.O = O; p.k = k;
  p.stride = stride; p.pad = pad; p.per_sample = per_sample;
  p.bf16 = out_bf16 ? 1 : 0;
  p.tma_out = 0;
  p.Ho = (H + 2 * pad - k) / stride + 1;
  p.Wo = (W + 2 * pad - k) / stride + 1;
  p.K = k * k * C;
  const long long M = (long long)N * p.Ho * p.Wo;
  if (M <= 0 || M + kBM >= (1LL << 31) || O <= 0 || p.K <= 0 || stride <= 0)
    return (int)cudaErrorInvalidValue;
  p.M = (int)M;
  cudaStream_t st = (cudaStream_t)stream;
  const bool gemm = C % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                    (uintptr_t)w % 16 == 0;
  if (!gemm)
    return p.bf16 ? launch_direct<true>(p, st) : launch_direct<false>(p, st);
  if (O > 128) return launch_gemm<256>(p, st);
  return O > 64 ? launch_gemm<128>(p, st) : launch_gemm<64>(p, st);
}
