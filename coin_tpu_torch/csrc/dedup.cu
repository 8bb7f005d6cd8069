// K11 · IoU self-clustering for Hopper: each box's representative is the
// lowest index of its cluster, the boxes joined transitively at
// IoU >= thr among the valid rows.
//
// Replaces: coin_tpu/ops/dedup.py `self_cluster_index` (:38) and
// `self_cluster_mask` (:55), which the JAX package computes as the
// transitive closure of the n x n adjacency by ceil(log2 n) boolean matrix
// squarings on the TPU's MXU (n^3 log n operations), then takes the first
// reachable index of each row.
//
// Semantics: IoU as coin_tpu/ops/boxes.py `pairwise_iou` computes it, each
// step one correctly rounded f32 operation (no FMA contraction):
// inter = max(min(x2) - max(x1), 0) * max(min(y2) - max(y1), 0),
// union = (area_i + area_j) - inter, iou = union > 0 ? inter / union : 0.
// An edge joins i and j when both are valid and iou >= thr; every row is
// joined to itself. rep[i] is the lowest index reachable from i (i for an
// invalid row), keep[i] = rep[i] == i and valid[i]: equal to JAX's.
//
// Bound: the serial propagation, not memory or arithmetic. At the teacher's
// shapes (4 images x 512 proposals) the kernel reads 32 KB and does 4 x
// 512^2 / 2 IoUs. Design: one block per image. The boxes go to shared
// memory, then the adjacency as a bitmask (n x ceil(n / 32) words: 32 KB at
// n = 512, dynamic shared memory up to n = 1024), one word per thread step.
// Labels start at their index and propagate the minimum over each row's set
// bits, with pointer jumping (label[i] = label[label[i]], which only
// lowers a label within its cluster), until a sweep changes nothing: then
// every cluster carries its lowest index.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxN = 1024;

// the bitmask's words, rounded up to 16 bytes for the boxes behind it
__host__ __device__ inline size_t adj_words(int n) {
  return (((size_t)n * ((n + 31) / 32)) + 3) / 4 * 4;
}

__global__ void __launch_bounds__(kThreads)
self_cluster_kernel(const float* __restrict__ boxes,
                    const uint8_t* __restrict__ valid, float thr, int n,
                    uint8_t* __restrict__ keep, int64_t* __restrict__ rep) {
  extern __shared__ uint32_t smem[];
  const int words = (n + 31) / 32;
  uint32_t* adj = smem;                                   // n x words
  float4* box = reinterpret_cast<float4*>(adj + adj_words(n));
  float* area = reinterpret_cast<float*>(box + n);
  int* label = reinterpret_cast<int*>(area + n);
  uint8_t* ok = reinterpret_cast<uint8_t*>(label + n);
  __shared__ int changed;

  const int img = blockIdx.x;
  const float4* bx = reinterpret_cast<const float4*>(boxes) + (size_t)img * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float4 b = bx[i];
    box[i] = b;
    area[i] = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
    ok[i] = valid[(size_t)img * n + i];
    label[i] = i;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n * words; k += blockDim.x) {
    const int i = k / words;
    const int j0 = (k % words) * 32;
    uint32_t bits = 0;
    const float4 a = box[i];
    for (int jj = 0; jj < 32 && j0 + jj < n; ++jj) {
      const int j = j0 + jj;
      bool edge = i == j;
      if (!edge && ok[i] && ok[j]) {
        const float4 b = box[j];
        const float iw =
            fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
        const float ih =
            fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
        const float inter = __fmul_rn(iw, ih);
        const float uni = __fsub_rn(__fadd_rn(area[i], area[j]), inter);
        const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
        edge = iou >= thr;
      }
      bits |= (uint32_t)edge << jj;
    }
    adj[k] = bits;
  }
  __syncthreads();

  do {
    __syncthreads();
    if (threadIdx.x == 0) changed = 0;
    __syncthreads();
    int mine = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int m = label[i];
      const uint32_t* row = adj + (size_t)i * words;
      for (int w = 0; w < words; ++w) {
        uint32_t bits = row[w];
        while (bits) {
          const int j = w * 32 + __ffs(bits) - 1;
          bits &= bits - 1;
          m = min(m, label[j]);
        }
      }
      if (m < label[i]) {
        atomicMin(&label[i], m);
        mine = 1;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      atomicMin(&label[i], label[label[i]]);
    }
    if (mine) changed = 1;
    __syncthreads();
  } while (changed);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = label[i];
    rep[(size_t)img * n + i] = r;
    keep[(size_t)img * n + i] = (uint8_t)(r == i && ok[i]);
  }
}

size_t smem_bytes(int n) {
  return adj_words(n) * 4 + (size_t)n * (16 + 4 + 4 + 1);
}

}  // namespace

// boxes (B, n, 4) float32 xyxy, valid (B, n) uint8 → keep (B, n) uint8,
// rep (B, n) int64. n <= 1024. Returns the CUDA error code of the launch.
extern "C" int coin_self_cluster(const void* boxes, const void* valid,
                                 void* keep, void* rep, int B, int n,
                                 float thr, void* stream) {
  if (B <= 0 || n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      self_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = std::min(kThreads, ((n + 31) / 32) * 32);
  self_cluster_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const uint8_t*)valid, thr, n, (uint8_t*)keep,
      (int64_t*)rep);
  return (int)cudaGetLastError();
}
