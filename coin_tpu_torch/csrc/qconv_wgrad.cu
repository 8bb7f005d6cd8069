// K2 wgrad · the s8 weight gradient of a stride-1 'same' convolution.
//
// Replaces: coin_tpu/ops/qconv.py `_vjp_bwd`'s int8 wgrad (:203-208), XLA's
// conv_general_dilated(xq, gq, dimension_numbers=("CHWN", "IHWO", "HWNC"),
// preferred_element_type=int32) then `* (xs * gs)`:
//   dw[o, i, kh, kw] = f32(sum_{n,h,w} xq[n, h+kh-p, w+kw-p, i] * gq[n,h,w,o])
//                      * (xs * gs)
// The s32 sum wraps as XLA's s32 does. Integer addition is associative, so
// the split sums below, added in any order, give the same bits on every run.
//
// GEMM view, per tap (kh, kw): D[o][i] = sum_m G[m][o] * X_tap[m][i] over the
// N * H * W positions m (up to 1728 * 196 = 338 688 in res5). Bound:
// operations, 2.0e12 MACs per res5 pass, 2.02 ms at 1979 TOPS (2.32 ms over
// the padded grid below).
//
// Design. Hopper's s8 `wgmma` reads both operands K-major from shared memory,
// and no instruction transposes 8-bit data, so the positions (K) have to be
// contiguous before the GEMM:
// 1. The operands arrive laid out: K2's quantisation (csrc/quantize.cu)
//    writes each s8 tensor of the int8 weight gradient a second time,
//    channel-major, from the same pass that writes its NHWC values: Xt (I, Pp)
//    and Gt (O, Pp) over the positions
//    (b, h, w, j) of image B b + j, in blocks of B images, each block an
//    (H+p) x (W+p) grid of pixels with p halo rows below and p halo columns
//    right of the image; zeros on the halo and for the images past N. A tap
//    is then a constant shift of the positions by a multiple of B:
//      off = ((kh-p)(W+p) + kw-p) B,
//      D_tap[o][i] = sum_m Gt[o][m] * Xt[i][m + off],
//    exact because Gt is zero on the halo and a pixel shifted by at most p
//    rows and columns lands on its neighbour, on a halo column or row (its
//    own, or the previous row's or block's) or before the first position,
//    where TMA reads zeros. B = 128 for the 3 x 3 convs: TMA's 128-byte
//    swizzle needs an innermost coordinate on 16 bytes, and a box that does
//    not start on 128 bytes halves the GEMM's rate (measured), so every
//    shift is a whole stage; the shifts are short (at most 16 stages), so
//    the 9 taps' blocks in flight read the same tiles through L2. The halo
//    and the images up to 1792 cost 19 % more MACs at 14 x 14 and 35 % at
//    7 x 7. The 1 x 1 convs have no shift (p = 0, B = 1): their layout is a
//    plain transpose in NHWC's own order.
// 2. The GEMM (`gemm_kernel`): a 128 (o) x 256 (i) tile per block and tap,
//    wgmma.m64n256k32.s32.s8.s8 from two consumer warpgroups (64 rows of o
//    each, the s32 sums in 128 registers a thread), fed by one producer
//    thread through a 4-stage ring of 128-position-deep tiles that TMA loads
//    with the 128-byte swizzle, under full/empty mbarriers. Two blocks (o
//    tiles 2q, 2q+1) form a cluster and share their X tile: each loads half
//    of it by TMA multicast into both, which cuts the reads from L2, the
//    GEMM's limit at this tile size, by a third. TMA zero-fills the
//    coordinates that fall off either end of the grid, so the GEMM does no
//    index arithmetic. The positions are split over the fewest blocks that
//    fill their last wave of SMs to 90 %; each block stores its s32 tile
//    into its own slice of a scratch buffer, taps fastest in the block order
//    so that the blocks in flight read the same positions through L2.
// 3. `finish_kernel` adds the splits in s32 (wrapping) and rescales:
//    dw = __fmul_rn(f32(acc), xs * gs).

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from cudart
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // o rows of a block: two consumer warpgroups
constexpr int kBN = 256;  // i rows of a block
constexpr int kBK = 128;  // positions (bytes) of one stage
constexpr int kStages = 4;
constexpr int kABytes = kBM * kBK;
constexpr int kBBytes = kBN * kBK;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmem = kStages * kStageBytes + 1024;  // + 1024-byte alignment
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr long long kWatchdogCycles = 20000000000LL;  // about ten seconds

// images per block of the layout: 128 where taps shift the positions, 1
// (the natural order of NHWC, read front to back) for a 1 x 1 conv
__host__ __device__ __forceinline__ int image_block(int k) {
  return k > 1 ? 128 : 1;
}

struct Gemm {
  int* part;  // (splits, k*k, O, I) s32
  int I, O, k, pad, Wg, kt_per, nkt, tiles_i, tiles;
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

// the same box into the same offset of every CTA in `mask`, each CTA's
// barrier at `bar`'s offset counting its bytes
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   int c0, int c1, uint32_t bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
      "h"(mask)
      : "memory");
}

// arrive on the barrier at `bar`'s offset in the cluster's CTA `rank`
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n"
               ::: "memory");
}

// K-major operand, rows of 128 bytes, 128-byte swizzle: 8-row groups 1024
// bytes apart (SBO); the leading offset is unused in this layout
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
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int j = 0; j < 128; ++j) asm volatile("" : "+r"(d[j])::"memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap gmap,
                const __grid_constant__ CUtensorMap xmap, Gemm p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // a cluster of two blocks: o tiles 2 q and 2 q + 1 of one tap, i tile and
  // split; each loads its own G rows and half of the shared X rows, which
  // TMA writes into both blocks
  const uint32_t rank = cluster_rank();
  const int kk = p.k * p.k;
  const int c = blockIdx.x / 2;
  const int tap = c % kk, tile = (c / kk) % p.tiles, split = c / kk / p.tiles;
  const int o0 = ((tile / p.tiles_i) * 2 + rank) * kBM;
  const int i0 = (tile % p.tiles_i) * kBN;
  const int off =
      ((tap / p.k - p.pad) * p.Wg + (tap % p.k - p.pad)) * image_block(p.k);
  const int kt0 = split * p.kt_per;
  const int nk = min(p.kt_per, p.nkt - kt0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4);  // 2 consumers x 2 blocks
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages)
          mbar_wait(smem_u32(&empty[s]), (kt / kStages - 1) & 1);
        const uint32_t fb = smem_u32(&full[s]);
        const uint32_t sa = base + s * kStageBytes;
        const int pos = (kt0 + kt) * kBK;
        // the second block of an odd count of o tiles loads no G rows; its
        // sums are never stored
        mbar_expect_tx(fb, o0 < p.O ? kStageBytes : kStageBytes - kABytes);
        if (o0 < p.O) tma_load(sa, &gmap, pos, o0, fb);
        tma_load_multicast(sa + kABytes + rank * (kBBytes / 2), &xmap,
                           pos + off, i0 + rank * (kBN / 2), fb, 0x3);
      }
    }
    __syncwarp();
    cluster_sync();  // the peer may still arrive on this block's barriers
    return;
  }

  const int cw = wg - 1;  // this consumer's 64 rows of o
  int d[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) d[j] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(smem_u32(&full[s]), (kt / kStages) & 1);
    const uint32_t sa = base + s * kStageBytes + cw * 64 * kBK;
    const uint32_t sb = base + s * kStageBytes + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < kBK / 32; ++kq)
      wgmma_s8(d, desc_sw128(sa + kq * 32), desc_sw128(sb + kq * 32));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(d);
    if (kt > 0 && threadIdx.x % 128 == 0) {
      // the stage is free once both blocks' consumers are done with it:
      // either block's multicast writes into both
      const uint32_t eb = smem_u32(&empty[(kt - 1) % kStages]);
      mbar_arrive_at(eb, 0);
      mbar_arrive_at(eb, 1);
    }
  }
  wgmma_wait<0>();
  fence_acc(d);

  // accumulator layout of m64nN: warp w of the warpgroup holds rows
  // 16w .. 16w+15; for each 8 columns j, d[4j], d[4j+1] at row lane/4,
  // columns 2 (lane%4) + {0, 1}, and d[4j+2], d[4j+3] eight rows below
  const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
  const int r0 = o0 + cw * 64 + w * 16 + lane / 4;
  int* out = p.part + ((long long)split * kk + tap) * p.O * p.I;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int i = i0 + j * 8 + (lane % 4) * 2;
    if (i >= p.I) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = r0 + h * 8;
      if (o < p.O)
        *reinterpret_cast<int2*>(out + (long long)o * p.I + i) =
            make_int2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
  cluster_sync();
}

// part (splits, k*k, O, I) s32 -> dw (O, I, k, k) f32 =
// f32(wrapping sum over the splits) * (xs * gs)
__global__ void finish_kernel(const int* __restrict__ part,
                              const float* __restrict__ xs,
                              const float* __restrict__ gs, float* dw, int O,
                              int I, int kk, int splits) {
  const long long plane = (long long)O * I, n = plane * kk;
  const float s = __fmul_rn(xs[0], gs[0]);
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const int tap = (int)(idx % kk);
    const long long oi = idx / kk;
    uint32_t acc = 0;
    for (int sp = 0; sp < splits; ++sp)
      acc += (uint32_t)part[((long long)sp * kk + tap) * plane + oi];
    dw[idx] = __fmul_rn(__int2float_rn((int)acc), s);
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

// (rows, Pp) s8 with a box of 128 positions x box_rows rows, 128-byte swizzle;
// coordinates off the tensor read as zeros
bool encode(CUtensorMap* map, const void* t, long long Pp, int rows,
            int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)Pp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Pp};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(t), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the GEMM's launch: clusters of two blocks along o
cudaLaunchConfig_t gemm_config(unsigned blocks, cudaStream_t st,
                               cudaLaunchAttribute* cluster) {
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = 2;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = st;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// the GEMM's blocks resident at once: two for every cluster that fits (the
// SMs of a cluster share a GPC), else one per SM
int wave_blocks() {
  static int n = 0;
  if (n > 0) return n;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = gemm_config(2, 0, &cluster);
  int clusters = 0;
  if (cudaFuncSetAttribute(gemm_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmem) == cudaSuccess &&
      cudaOccupancyMaxActiveClusters(&clusters, (void*)gemm_kernel, &cfg) ==
          cudaSuccess &&
      clusters > 0) {
    n = 2 * clusters;
  } else {
    cudaGetLastError();  // a failed query leaves no error for the launches
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// the split of the positions: the fewest splits whose blocks fill their last
// wave to 90 %, so that each block runs long and few s32 partial tiles are
// stored; at least 4 stages a split
void plan(long long Pp, int I, int O, int k, int* splits, int* kt_per) {
  const int nkt = (int)((Pp + kBK - 1) / kBK);
  const long long tiles = (long long)k * k * ((O + 2 * kBM - 1) / (2 * kBM)) *
                          2 * ((I + kBN - 1) / kBN);
  const int sms = wave_blocks();
  int best = 1;
  double best_eff = 0.0;
  for (int s = 1; s <= 64 && s <= nkt; ++s) {
    const long long blocks = tiles * s;
    const long long waves = (blocks + sms - 1) / sms;
    const double eff = (double)blocks / (double)(waves * sms);
    if (eff > best_eff + 1e-9) {
      best_eff = eff;
      best = s;
    }
    if (eff >= 0.9) break;
  }
  int per = (nkt + best - 1) / best;
  if (per < 4) per = 4;
  *kt_per = per;
  *splits = (nkt + per - 1) / per;
}

// the layout's row: the grid of positions rounded up to 16 bytes for TMA
long long positions(int N, int H, int W, int k) {
  const int p = k / 2, ib = image_block(k);
  const long long grid = (long long)(N + ib - 1) / ib * (H + p) * (W + p) * ib;
  return (grid + 15) / 16 * 16;
}

}  // namespace

// The number of position splits of the GEMM (the leading dimension of its
// s32 scratch).
extern "C" int coin_qconv_wgrad_splits(int N, int H, int W, int I, int O,
                                       int k) {
  int splits, per;
  plan(positions(N, H, W, k), I, O, k, &splits, &per);
  return splits;
}

// xt (I, Pp) and gt (O, Pp) s8 in the layout above (coin_quantize's `lay`);
// xs, gs: one f32 each; part: splits x k*k x O x I s32 of scratch; dw:
// (O, I, k, k) f32. Returns the CUDA error code of the launches.
extern "C" int coin_qconv_wgrad(const void* xt, const void* gt,
                                const float* xs, const float* gs, int* part,
                                float* dw, int N, int H, int W, int I, int O,
                                int k, int splits, void* stream) {
  const long long Pp = positions(N, H, W, k);
  if (N <= 0 || I <= 0 || O <= 0 || Pp >= (1LL << 31) || (uintptr_t)xt % 16 ||
      (uintptr_t)gt % 16)
    return (int)cudaErrorInvalidValue;
  Gemm p;
  int want;
  plan(Pp, I, O, k, &want, &p.kt_per);
  if (want != splits) return (int)cudaErrorInvalidValue;
  CUtensorMap gmap, xmap;
  if (!encode(&gmap, gt, Pp, O, kBM) || !encode(&xmap, xt, Pp, I, kBN / 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  p.part = part;
  p.I = I; p.O = O; p.k = k; p.pad = k / 2; p.Wg = W + k / 2;
  p.nkt = (int)((Pp + kBK - 1) / kBK);
  p.tiles_i = (I + kBN - 1) / kBN;
  p.tiles = (O + 2 * kBM - 1) / (2 * kBM) * p.tiles_i;  // o-tile pairs x i
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = gemm_config(
      (unsigned)((long long)k * k * p.tiles * 2 * splits), st, &cluster);
  e = cudaLaunchKernelEx(&cfg, gemm_kernel, gmap, xmap, p);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)O * I * k * k;
  long long fb = (n + 255) / 256;
  if (fb > 132 * 8) fb = 132 * 8;
  finish_kernel<<<(unsigned)fb, 256, 0, st>>>(part, xs, gs, dw, O, I, k * k,
                                               splits);
  return (int)cudaGetLastError();
}
