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
// Bound: the IoU tests. At the shipped eval shapes (4 x 6000 RPN boxes)
// about 72 M box pairs are tested, a few hundred M flops: microseconds at
// the card's f32 rate, so launch and the serial sweep dominate. Design:
// kernel 1 tests each 64 x 64 tile of pairs in one block (one thread per
// row, the 64 column boxes in shared memory) and writes one 64-bit word of
// suppression bits per (row, column tile); tiles below the diagonal and
// rows past `counts[b]` are skipped. Kernel 2 is one block per image that
// walks the row tiles in order: one thread resolves the 64 rows of the
// diagonal tile serially from shared memory, then its 512 threads OR the
// kept rows' words of all later column tiles into the removed set, one
// word per thread per pass (a shared-memory atomicOr), so the loads of a
// tile are in flight together. The sweep stays on the device, so no
// mask is copied to the host and nothing synchronises per image.
//
// IoU (coin_tpu/ops/boxes.py:28-48): half-open or inclusive (+1) widths,
// iou = union > 0 ? inter / union : 0, suppression iff iou > threshold.
// Every product and sum is an explicitly rounded intrinsic, so the compiler
// contracts nothing into an FMA and the bits equal those of the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kSweepThreads = 512;

__device__ __forceinline__ float iou(const float* a, const float* b,
                                     float off) {
  float w = fmaxf(__fadd_rn(__fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])),
                            off), 0.0f);
  float h = fmaxf(__fadd_rn(__fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])),
                            off), 0.0f);
  float inter = __fmul_rn(w, h);
  float area_a = __fmul_rn(__fadd_rn(__fsub_rn(a[2], a[0]), off),
                           __fadd_rn(__fsub_rn(a[3], a[1]), off));
  float area_b = __fmul_rn(__fadd_rn(__fsub_rn(b[2], b[0]), off),
                           __fadd_rn(__fsub_rn(b[3], b[1]), off));
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float* __restrict__ boxes,
                const int* __restrict__ counts, uint64_t* __restrict__ mask,
                int n, int col_tiles, float threshold, float off) {
  const int col_tile = blockIdx.x, row_tile = blockIdx.y, b = blockIdx.z;
  const int count = counts[b];
  const int row0 = row_tile * kTile, col0 = col_tile * kTile;
  if (col_tile < row_tile || row0 >= count || col0 >= count) return;
  const int rows = min(kTile, count - row0), cols = min(kTile, count - col0);

  __shared__ float cb[kTile * 4];
  const float* bb = boxes + (size_t)b * n * 4;
  if (threadIdx.x < cols) {
    for (int k = 0; k < 4; ++k) {
      cb[threadIdx.x * 4 + k] = bb[(size_t)(col0 + threadIdx.x) * 4 + k];
    }
  }
  __syncthreads();
  if (threadIdx.x >= rows) return;
  const int i = row0 + threadIdx.x;
  float a[4];
  for (int k = 0; k < 4; ++k) a[k] = bb[(size_t)i * 4 + k];
  uint64_t bits = 0;
  const int start = (col_tile == row_tile) ? threadIdx.x + 1 : 0;
  for (int j = start; j < cols; ++j) {
    if (iou(a, cb + j * 4, off) > threshold) bits |= 1ull << j;
  }
  mask[((size_t)b * n + i) * col_tiles + col_tile] = bits;
}

__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(const uint64_t* __restrict__ mask,
                 const int* __restrict__ counts, uint8_t* __restrict__ keep,
                 int n, int col_tiles) {
  extern __shared__ uint64_t removed[];   // col_tiles words
  __shared__ uint64_t diag[kTile];
  __shared__ uint64_t kept_word;
  const int b = blockIdx.x;
  const int count = counts[b];
  const uint64_t* mb = mask + (size_t)b * n * col_tiles;
  uint8_t* kb = keep + (size_t)b * n;
  for (int t = threadIdx.x; t < col_tiles; t += blockDim.x) removed[t] = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) kb[i] = 0;
  __syncthreads();

  const int row_tiles = (count + kTile - 1) / kTile;
  for (int rt = 0; rt < row_tiles; ++rt) {
    const int row0 = rt * kTile;
    const int rows = min(kTile, count - row0);
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      diag[r] = mb[(size_t)(row0 + r) * col_tiles + rt];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      uint64_t rem = removed[rt], kept = 0;
      for (int r = 0; r < rows; ++r) {
        if (!((rem >> r) & 1ull)) {
          kept |= 1ull << r;
          rem |= diag[r];
        }
      }
      kept_word = kept;
    }
    __syncthreads();
    const uint64_t kept = kept_word;
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      kb[row0 + r] = (uint8_t)((kept >> r) & 1ull);
    }
    // every (kept row, later column tile) word at once: neighbouring
    // threads read neighbouring words, and no thread waits on a chain of
    // loads
    const int later = row_tiles - rt - 1;
    for (int i = threadIdx.x; i < rows * later; i += blockDim.x) {
      const int r = i / later, ct = rt + 1 + i % later;
      if ((kept >> r) & 1ull) {
        const uint64_t w = mb[(size_t)(row0 + r) * col_tiles + ct];
        if (w) {
          atomicOr(reinterpret_cast<unsigned long long*>(&removed[ct]),
                   (unsigned long long)w);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// boxes: (batch, n, 4) float32, sorted; counts: (batch,) int32 on the
// device; mask: (batch, n, ceil(n / 64)) uint64 scratch; keep: (batch, n)
// uint8. Returns the CUDA error code of the launches (0 on success).
extern "C" int coin_nms(const void* boxes, const void* counts, void* mask,
                        void* keep, int batch, int n, float threshold,
                        int plus1, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int col_tiles = (n + kTile - 1) / kTile;
  if ((size_t)col_tiles * sizeof(uint64_t) > 40 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(col_tiles, col_tiles, batch);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(
      (const float*)boxes, (const int*)counts, (uint64_t*)mask, n, col_tiles,
      threshold, plus1 ? 1.0f : 0.0f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_sweep_kernel<<<batch, kSweepThreads, col_tiles * sizeof(uint64_t), s>>>(
      (const uint64_t*)mask, (const int*)counts, (uint8_t*)keep, n,
      col_tiles);
  return (int)cudaGetLastError();
}
