// K3 · exact greedy hard NMS for Hopper, batched over images.
//
// Replaces: coin_tpu/ops/nms.py `_nms_sorted` / `_self_suppress` (the
// tiled fixpoint that the JAX package runs so that XLA sees batched IoU
// contractions instead of thousands of scalar steps on the TPU).
//
// Input: boxes already sorted by descending score per image, offset by
// class and shifted by +1 by the Python wrapper (coin_tpu_torch/ops/nms.py);
// `counts[b]` is the number of valid (leading) rows of image b. Output: the
// keep mask over the sorted rows.
//
// Bound: the IoU tests, about 72 M pairs at the eval shapes (4 x 6000 RPN
// boxes), 15 operations each: 0.0145 ms at the card's f32 rate. What a
// greedy NMS cannot spread is its chain: whether row i is kept depends on
// every kept row before it, so the sweep runs on one SM per image. Two
// kernels:
// 1. The mask: bit j of word (row i, column tile ct) is set when row i
//    suppresses row 64 ct + j (IoU above the threshold, i < j). A block of
//    256 threads tests one row tile against 4 column tiles (a thread per
//    row and column tile, its 64 tests unrolled, branch-free), and the grid
//    enumerates only the tiles on or above the diagonal. Words are stored
//    tile by tile, the 64 rows of one (row tile, column tile) contiguous,
//    so that the mask's writes and the sweep's reads are 256-byte runs per
//    warp. The IoU test drops the IEEE division where that keeps every bit
//    (below), and the kernel is built for each width convention. The first
//    version ran a block of 64 threads per tile over the whole square,
//    more than half of them returning at once, and divided for every pair.
// 2. The sweep: one block of 512 threads per image walks the row tiles in
//    order, with one barrier per tile. Warp 0 resolves the tile's 64 rows
//    from registers: its lanes hold the diagonal words and every lane runs
//    the serial decision on shuffled words; where at most 8 rows of the
//    tile suppress another row of it, the lanes step through those rows
//    only, else through all 64, unrolled. It writes the keep bytes and ORs
//    the kept rows' words against the next column tile itself (a warp
//    reduction: the next tile's removed set, ready without a barrier).
//    After the barrier all threads OR the kept rows' words against the
//    column tiles beyond into the removed set (shared-memory atomics); the
//    barrier of the next tile orders them before the tile after it reads
//    its removed set. Each thread loads its words of the next row tile
//    while the current one resolves. The first version loaded the diagonal
//    words after a barrier, resolved them in one thread from shared memory
//    and passed three barriers a tile.
// A ring of three tiles of words in shared memory (cp.async) in place of
// the registers' one tile was no faster: a tile's time is its chain and its
// barrier, not its loads. A thread-block cluster per image would spread
// the atomics, not the chain.
//
// IoU and its test without the division: csrc/iou_test.cuh, shared with
// K11 (csrc/dedup.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "iou_test.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kGroup = 4;                      // column tiles of a mask block
constexpr int kMaskThreads = kTile * kGroup;
constexpr int kSweepThreads = 512;
constexpr int kColGroups = kSweepThreads / kTile;
constexpr int kPrefetch = 12;   // words of the next tile a sweep thread holds
constexpr int kSparse = 8;      // suppressing rows a tile steps through alone

template <bool kPlus1>
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float4* __restrict__ boxes,
                const int* __restrict__ counts, uint64_t* __restrict__ mask,
                int n, int col_tiles, int groups, iou_test::Split s) {
  __shared__ float4 cb[kGroup][kTile];
  __shared__ float ca[kGroup][kTile];
  const float off = kPlus1 ? 1.0f : 0.0f;
  const int b = blockIdx.y;
  const int count = counts[b];
  int l = blockIdx.x, k = 0;
  while (l >= kGroup * (groups - k)) {
    l -= kGroup * (groups - k);
    ++k;
  }
  const int rt = kGroup * k + l / (groups - k);
  const int i = threadIdx.x % kTile, q = threadIdx.x / kTile;
  const int ct = kGroup * (k + l % (groups - k)) + q;
  const int row0 = rt * kTile, col0 = ct * kTile;
  if (row0 >= count) return;
  const float4* bb = boxes + (size_t)b * n;
  if (col0 + i < count) {
    const float4 c = bb[col0 + i];
    cb[q][i] = c;
    ca[q][i] = iou_test::area(c, off);
  }
  __syncthreads();
  if (ct < rt || col0 >= count || row0 + i >= count) return;
  const float4 a = bb[row0 + i];
  const float aa = iou_test::area(a, off);
  const int cols = min(kTile, count - col0);
  // the division-free test (iou_test.cuh); the pairs it does not decide
  // take the division after the loop
  uint64_t bits = 0, slow = 0;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const float inter = iou_test::intersection<kPlus1>(a, cb[q][j]);
    const float uni = iou_test::union_of(aa, ca[q][j], inter);
    const bool in = iou_test::decides(uni, s);
    if (in && iou_test::exceeds(inter, uni, s)) bits |= 1ull << j;
    if (!in && uni > 0.0f) slow |= 1ull << j;
  }
  uint64_t live = cols == kTile ? ~0ull : (1ull << cols) - 1;
  if (ct == rt) live &= i == kTile - 1 ? 0ull : ~0ull << (i + 1);
  bits &= live;
  slow &= live;
  if (0.0f > s.thr) bits |= live & ~slow;   // union <= 0 counts as IoU 0
  while (slow) {
    const int j = __ffsll((long long)slow) - 1;
    slow &= slow - 1;
    const float inter = iou_test::intersection<kPlus1>(a, cb[q][j]);
    const float uni = iou_test::union_of(aa, ca[q][j], inter);
    if (iou_test::exceeds_by_division(inter, uni, s.thr)) bits |= 1ull << j;
  }
  mask[(((size_t)b * col_tiles + rt) * col_tiles + ct) * kTile + i] = bits;
}

__device__ __forceinline__ uint64_t shfl64(uint64_t v, int lane) {
  const unsigned lo = __shfl_sync(0xffffffffu, (unsigned)v, lane);
  const unsigned hi = __shfl_sync(0xffffffffu, (unsigned)(v >> 32), lane);
  return ((uint64_t)hi << 32) | lo;
}

__device__ __forceinline__ uint64_t or_across_warp(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned lo = __shfl_xor_sync(0xffffffffu, (unsigned)v, o);
    const unsigned hi = __shfl_xor_sync(0xffffffffu, (unsigned)(v >> 32), o);
    v |= ((uint64_t)hi << 32) | lo;
  }
  return v;
}

__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(const uint64_t* __restrict__ mask,
                 const int* __restrict__ counts, uint8_t* __restrict__ keep,
                 int n, int col_tiles) {
  extern __shared__ uint64_t removed[];   // col_tiles words
  __shared__ uint64_t kept_s[2];
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31;
  const int count = counts[b];
  const int nt = (count + kTile - 1) / kTile;
  const uint64_t* mb = mask + (size_t)b * col_tiles * col_tiles * kTile;
  uint8_t* kb = keep + (size_t)b * n;
  for (int i = t; i < col_tiles; i += kSweepThreads) removed[i] = 0;
  for (int i = count + t; i < n; i += kSweepThreads) kb[i] = 0;
  __syncthreads();
  if (nt == 0) return;

  // word (row tile rt, column tile ct, row) of this image's mask
  auto word = [&](int rt, int ct, int row) {
    return mb[((size_t)rt * col_tiles + ct) * kTile + row];
  };
  // a thread's share of a tile's later words: its row against the column
  // tiles rt + 2 + cg + kColGroups * m
  const int row = t % kTile, cg = t / kTile;
  uint64_t nxt[kPrefetch];
  auto fetch = [&](int rt) {
    const bool in = row < count - rt * kTile;
#pragma unroll
    for (int m = 0; m < kPrefetch; ++m) {
      const int ct = rt + 2 + cg + kColGroups * m;
      nxt[m] = in && ct < nt ? word(rt, ct, row) : 0ull;
    }
  };
  // warp 0's share: the diagonal words of rows lane and lane + 32, and
  // their words against the next column tile
  uint64_t nd0 = 0, nd1 = 0, nc0 = 0, nc1 = 0;
  auto fetch_diag = [&](int rt) {
    const int rows = count - rt * kTile;
    const bool next = rt + 1 < nt;
    nd0 = lane < rows ? word(rt, rt, lane) : 0ull;
    nd1 = lane + 32 < rows ? word(rt, rt, lane + 32) : 0ull;
    nc0 = next && lane < rows ? word(rt, rt + 1, lane) : 0ull;
    nc1 = next && lane + 32 < rows ? word(rt, rt + 1, lane + 32) : 0ull;
  };
  fetch(0);
  if (t < 32) fetch_diag(0);

  uint64_t carry = 0;   // warp 0: the last tile's kept rows against this one
  for (int rt = 0; rt < nt; ++rt) {
    uint64_t cur[kPrefetch];
#pragma unroll
    for (int m = 0; m < kPrefetch; ++m) cur[m] = nxt[m];
    const uint64_t d0 = nd0, d1 = nd1, c0 = nc0, c1 = nc1;
    if (rt + 1 < nt) {
      fetch(rt + 1);
      if (t < 32) fetch_diag(rt + 1);
    }
    if (t < 32) {
      const int rows = min(kTile, count - rt * kTile);
      uint64_t rem = removed[rt] | carry;
      uint64_t nz = ((uint64_t)__ballot_sync(0xffffffffu, d1 != 0) << 32) |
                    __ballot_sync(0xffffffffu, d0 != 0);
      if (__popcll(nz) <= kSparse) {
        // few rows of the tile suppress others: only they move the set
        while (nz) {
          const int r = __ffsll((long long)nz) - 1;
          nz &= nz - 1;
          const uint64_t d = shfl64(r < 32 ? d0 : d1, r & 31);
          if (!((rem >> r) & 1ull)) rem |= d;
        }
      } else {
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          const uint64_t d = shfl64(r < 32 ? d0 : d1, r & 31);
          if (!((rem >> r) & 1ull)) rem |= d;
        }
      }
      const uint64_t kept = ~rem & (rows == kTile ? ~0ull
                                                  : (1ull << rows) - 1);
      if (lane == 0) kept_s[rt & 1] = kept;
      uint8_t* kr = kb + rt * kTile;
      if (lane < rows) kr[lane] = (uint8_t)((kept >> lane) & 1ull);
      if (lane + 32 < rows) {
        kr[lane + 32] = (uint8_t)((kept >> (lane + 32)) & 1ull);
      }
      carry = or_across_warp(((kept >> lane) & 1ull ? c0 : 0ull) |
                             ((kept >> (lane + 32)) & 1ull ? c1 : 0ull));
    }
    __syncthreads();
    if ((kept_s[rt & 1] >> row) & 1ull) {
#pragma unroll
      for (int m = 0; m < kPrefetch; ++m) {
        if (cur[m]) {
          atomicOr(reinterpret_cast<unsigned long long*>(
                       &removed[rt + 2 + cg + kColGroups * m]),
                   (unsigned long long)cur[m]);
        }
      }
      // column tiles past the prefetched ones (N above 64 * 98)
      for (int ct = rt + 2 + cg + kColGroups * kPrefetch; ct < nt;
           ct += kColGroups) {
        const uint64_t w = word(rt, ct, row);
        if (w) {
          atomicOr(reinterpret_cast<unsigned long long*>(&removed[ct]),
                   (unsigned long long)w);
        }
      }
    }
  }
}

}  // namespace

// boxes: (batch, n, 4) float32, sorted, 16-byte aligned; counts: (batch,)
// int32 on the device; mask: (batch, T, T, 64) uint64 scratch with T =
// ceil(n / 64); keep: (batch, n) uint8. thr, h, umin and fast describe the
// IoU threshold (ops/nms.threshold_split). mid_event, when not null, is a
// CUDA event recorded between the two launches (to time them apart).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int coin_nms(const void* boxes, const void* counts, void* mask,
                        void* keep, int batch, int n, float thr, float h,
                        float umin, int fast, int plus1, void* mid_event,
                        void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int col_tiles = (n + kTile - 1) / kTile;
  if ((size_t)col_tiles * sizeof(uint64_t) > 40 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const int groups = (col_tiles + kGroup - 1) / kGroup;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)(2 * groups * (groups + 1)), (unsigned)batch);
  auto mask_kernel = plus1 ? nms_mask_kernel<true> : nms_mask_kernel<false>;
  mask_kernel<<<grid, kMaskThreads, 0, s>>>(
      (const float4*)boxes, (const int*)counts, (uint64_t*)mask, n,
      col_tiles, groups, iou_test::make_split(thr, h, umin, fast));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (mid_event) {
    err = cudaEventRecord((cudaEvent_t)mid_event, s);
    if (err != cudaSuccess) return (int)err;
  }
  nms_sweep_kernel<<<batch, kSweepThreads, col_tiles * sizeof(uint64_t), s>>>(
      (const uint64_t*)mask, (const int*)counts, (uint8_t*)keep, n,
      col_tiles);
  return (int)cudaGetLastError();
}
