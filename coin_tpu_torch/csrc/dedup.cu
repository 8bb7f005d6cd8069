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
// step one correctly rounded f32 operation (no FMA contraction). An edge
// joins i and j when both are valid and iou >= thr; every row is joined to
// itself. rep[i] is the lowest index reachable from i (i for an invalid
// row), keep[i] = rep[i] == i and valid[i]: equal to JAX's.
//
// Bound: the IoU tests (n (n - 1) / 2 pairs of about 15 operations an
// image) and, behind them, the chains of the closure. At the teacher's
// shapes (4 images x 512 proposals) the work is 0.12 us at the f32 rate;
// what costs is spreading it and joining the results. Design: one launch,
// a thread-block cluster per image of min(16, ceil(tiles / 16)) blocks, one
// warp a tile of the upper triangle at most (9 blocks at n = 512, 16 from
// n = 673). 16 is a non-portable size: 8 where the card cannot hold a
// cluster of 16.
// 1. Every block stages the image's boxes, areas and valid bits in shared
//    memory; the cluster meets once, so that every block has started.
// 2. The tiles of 32 x 32 pairs on or above the diagonal are dealt to the
//    cluster's warps. A lane tests its row against the tile's 32 columns
//    with the division-free test of csrc/iou_test.cuh at thr-, the f32 just
//    below thr (a rounded quotient is >= thr exactly when it is > thr-;
//    unions outside its range divide), and stores its word of edges into
//    the first block's shared memory (distributed shared memory). The IoU
//    is symmetric in IEEE arithmetic (min, max and area_i + area_j
//    commute), so the lower triangle is not tested.
// 3. After the cluster's second barrier the first block alone joins the
//    edges by union-find in shared memory: each set bit (i < j) hangs the
//    larger of the two roots below the smaller with atomicCAS, which
//    succeeds only on a root, and finds halve their paths. A root is only
//    ever hung below a smaller index of its own cluster, so each cluster's
//    root is its lowest index whatever order the hooks land in: the result
//    is deterministic and equal to the closure's. Then every row walks to
//    its root, and keep and rep are written.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "iou_test.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 1024;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;

// A block's dynamic shared memory, in bytes from its start: the boxes and
// areas (rows padded to the tiles), the union-find parents, the valid bits
// (a word per row tile), the tiles' (row tile, column tile) and the edge
// words (a word per row of each tile; used in the first block only).
struct Layout {
  int tiles_per_side, tiles;
  size_t box, area, parent, valid, tile, mask, total;
};

__host__ __device__ inline Layout layout(int n) {
  Layout l;
  l.tiles_per_side = (n + 31) / 32;
  l.tiles = l.tiles_per_side * (l.tiles_per_side + 1) / 2;
  const size_t rows = 32 * (size_t)l.tiles_per_side;
  l.box = 0;
  l.area = l.box + rows * sizeof(float4);
  l.parent = l.area + rows * sizeof(float);
  l.valid = l.parent + rows * sizeof(int);
  l.tile = l.valid + l.tiles_per_side * sizeof(unsigned);
  l.mask = l.tile + ((size_t)l.tiles * sizeof(uchar2) + 3) / 4 * 4;
  l.total = l.mask + (size_t)l.tiles * 32 * sizeof(unsigned);
  return l;
}

// The root of x; every node on the way is hung below its grandparent (an
// ancestor, so the halving is safe beside other finds and hooks).
__device__ __forceinline__ int find(volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    const int g = parent[p];
    if (g == p) return p;
    parent[x] = g;
    x = g;
    p = parent[x];
  }
  return x;
}

// Join the trees of a and b: the larger root goes below the smaller. The
// CAS fails where another thread hung that root first; then retry.
__device__ __forceinline__ void unite(volatile int* parent, int a, int b) {
  while (true) {
    a = find(parent, a);
    b = find(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    if (atomicCAS(const_cast<int*>(parent + b), b, a) == b) return;
  }
}

__global__ void __launch_bounds__(kThreads)
self_cluster_kernel(const float4* __restrict__ boxes,
                    const uint8_t* __restrict__ valid, int n,
                    iou_test::Split s, uint8_t* __restrict__ keep,
                    int64_t* __restrict__ rep) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int blocks = (int)cluster.num_blocks();
  const int img = blockIdx.x / blocks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout l = layout(n);
  float4* box = reinterpret_cast<float4*>(smem + l.box);
  float* area = reinterpret_cast<float*>(smem + l.area);
  int* parent = reinterpret_cast<int*>(smem + l.parent);
  unsigned* ok = reinterpret_cast<unsigned*>(smem + l.valid);
  uchar2* tile = reinterpret_cast<uchar2*>(smem + l.tile);
  unsigned* mask = reinterpret_cast<unsigned*>(smem + l.mask);

  const float4* bi = boxes + (size_t)img * n;
  const uint8_t* vi = valid + (size_t)img * n;
  // a warp's lanes take 32 consecutive rows together (the ballot)
  for (int i = tid; i < 32 * l.tiles_per_side; i += kThreads) {
    const float4 b = i < n ? bi[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    box[i] = b;
    area[i] = iou_test::area(b, 0.0f);
    parent[i] = i;
    const unsigned w = __ballot_sync(~0u, i < n && vi[i] != 0);
    if (lane == 0) ok[i / 32] = w;
  }
  for (int rt = tid; rt < l.tiles_per_side; rt += kThreads) {
    int t = rt * l.tiles_per_side - rt * (rt - 1) / 2;
    for (int ct = rt; ct < l.tiles_per_side; ++ct) {
      tile[t++] = make_uchar2((unsigned char)rt, (unsigned char)ct);
    }
  }
  cluster.sync();   // every block has started; its tables are ready

  unsigned* mask0 = cluster.map_shared_rank(mask, 0);
  for (int t = rank * kWarps + warp; t < l.tiles; t += blocks * kWarps) {
    const uchar2 rc = tile[t];
    const int i = 32 * rc.x + lane, c0 = 32 * rc.y;
    const float4 a = box[i];
    const float aa = area[i];
    unsigned bits = 0u, slow = 0u;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float inter = iou_test::intersection<false>(a, box[c0 + k]);
      const float uni = iou_test::union_of(aa, area[c0 + k], inter);
      const bool in = iou_test::decides(uni, s);
      bits |= (unsigned)(in && iou_test::exceeds(inter, uni, s)) << k;
      slow |= (unsigned)(!in && uni > 0.0f) << k;
    }
    // the valid columns j > i of a valid row i
    unsigned live = (ok[rc.x] >> lane) & 1u ? ok[rc.y] : 0u;
    if (rc.x == rc.y) live &= lane == 31 ? 0u : ~0u << (lane + 1);
    bits &= live;
    slow &= live;
    if (0.0f > s.thr) bits |= live & ~slow;   // union <= 0 counts as IoU 0
    for (; slow != 0u; slow &= slow - 1u) {
      const int k = __ffs(slow) - 1;
      const float inter = iou_test::intersection<false>(a, box[c0 + k]);
      const float uni = iou_test::union_of(aa, area[c0 + k], inter);
      if (iou_test::exceeds_by_division(inter, uni, s.thr)) bits |= 1u << k;
    }
    mask0[32 * t + lane] = bits;
  }
  cluster.sync();   // every edge word is in the first block
  if (rank != 0) return;

  volatile int* vp = parent;
  for (int k = tid; k < 32 * l.tiles; k += kThreads) {
    unsigned bits = mask[k];
    if (bits == 0u) continue;
    const uchar2 rc = tile[k / 32];
    const int i = 32 * rc.x + k % 32;
    for (; bits != 0u; bits &= bits - 1u) {
      unite(vp, i, 32 * rc.y + __ffs(bits) - 1);
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    int r = i;
    while (vp[r] != r) r = vp[r];
    rep[(size_t)img * n + i] = r;
    keep[(size_t)img * n + i] =
        (uint8_t)(r == i && ((ok[i / 32] >> (i % 32)) & 1u));
  }
}

cudaLaunchConfig_t config(int B, int blocks, size_t smem, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The shared-memory and cluster-size attributes, set once per device, and
// the largest cluster the device holds at n = kMaxN: 16 or 8 (portable).
cudaError_t prepare(int* max_cluster) {
  static int most[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && most[dev] > 0) {
    *max_cluster = most[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(self_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)layout(kMaxN).total);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(self_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(1, kMaxCluster, layout(kMaxN).total, 0, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, (void*)self_cluster_kernel,
                                     &cfg) != cudaSuccess) {
    cudaGetLastError();   // a failed query leaves no error for the launch
    clusters = 0;
  }
  *max_cluster = clusters > 0 ? kMaxCluster : 8;
  if (dev < kMaxDevices) most[dev] = *max_cluster;
  return cudaSuccess;
}

}  // namespace

// boxes (B, n, 4) float32 xyxy, 16-byte aligned; valid (B, n) bytes 0 or 1
// → keep (B, n) bytes 0 or 1, rep (B, n) int64. n <= 1024. thr, h, umin
// and fast: the split of thr-, the f32 just below the IoU threshold
// (ops/nms.threshold_split_at_least). Returns the CUDA error code of the
// launch.
extern "C" int coin_self_cluster(const void* boxes, const void* valid,
                                 void* keep, void* rep, int B, int n,
                                 float thr, float h, float umin, int fast,
                                 void* stream) {
  if (B <= 0 || n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  int max_cluster = 8;
  cudaError_t err = prepare(&max_cluster);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const Layout l = layout(n);
  const int blocks = std::min(max_cluster, (l.tiles + kWarps - 1) / kWarps);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(B, blocks, l.total, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, self_cluster_kernel, (const float4*)boxes,
                           (const uint8_t*)valid, n,
                           iou_test::make_split(thr, h, umin, fast),
                           (uint8_t*)keep, (int64_t*)rep);
  // read the last error either way: a refused launch leaves it set
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
