// K6 · Probabilistic-Fusion greedy NMS for Hopper, one image per block.
//
// Replaces: coin_tpu/ops/nms.py `fusion_nms` (:137-224), a `fori_loop`
// of masked vector ops over the N rows of one image, vmapped over the
// batch; the reference's `nms_bayesian` (coin/layers/nms.py:84-194).
//
// Input per image: N rows of boxes (N, 4) f32 xyxy (16-byte aligned),
// probs (N, C+1) f32 (finite), classes (N,) int32 and valid (N,) u8; the
// IoU threshold; the score method (0 probEn, 1 avg, 2 max) and box method
// (0 s-avg, 1 avg, 2 max). Output: N fused rows (boxes, scores, probs,
// classes, valid), valid rows first by descending fused score (stable on
// ties), the rest zero with class -1.
//
// Computes what JAX computes: the class offset (max coordinate over the
// valid rows and zeros, + 1, times the class), the seed score
// probs[class]; then repeatedly the seed (the highest alive score, the
// lowest index on ties), its cluster (alive rows whose +1 IoU with the
// seed exceeds the threshold, and the seed), the fused probs (probEn:
// softmax of the summed log(max(p, 1e-20)); avg: mean; max: the seed's
// row), the fused score and class, the fused box (s-avg: weights score /
// max(Σ score, 1e-20); avg: mean; max: the seed's box; the `max(csz, 1)`
// guards), until no row is alive or the seed's score is NEG_INF / 2 or
// less; finally a stable sort by descending fused score. (For 'max' the
// cluster's argmax is the seed itself: the cluster is a subset of the
// alive rows, of which the seed is the first with the highest score.)
//
// Bound: the serial chain of cluster steps, not bytes or operations: 4 x
// 256 rows of 9 classes are 50 KB in and out, a few hundred thousand
// operations. JAX's loop, and this kernel before, did all the work of a
// step in the chain (an argmax and n IoUs per emitted cluster). The seeds
// come in the order of a stable sort by descending score, and a seed's
// cluster holds only rows after it in that order (every row before it is
// a seed or in a cluster already), so the work splits into phases of one
// block of 512 threads, separated by barriers:
//  1. set-up: the rows into shared memory, the class offset, the seed
//     scores; the valid rows sorted by a bitonic sort of 64-bit keys
//     (score descending, index ascending), each one's class-offset box at
//     its rank;
//  2. the "+1 IoU > threshold" bits of every sorted pair (i, j > i), a
//     warp per row and 32 columns a ballot, into a triangle of bit words
//     in shared memory (66 KB at n = 1024, in the space the fused rows
//     take later), by K3's division-free IoU test (csrc/iou_test.cuh);
//  3. the sweep, one warp, bit operations only, 32 sorted rows at a
//     time: lane w holds the alive word w; in the tile, 32 steps in row
//     order, each with its row's diagonal word from a shuffle issued
//     ahead of the chain: a row still alive is a seed, its cluster the
//     alive bits of its word and itself, alive &= ~cluster; then each
//     later word loads the words of the tile's seeds at once and drops
//     their clusters in seed order; each row is marked with its cluster
//     as it leaves;
//  4. each cluster's rows in index order, by a stable counting sort;
//  5. the fusion, half a warp per cluster, lane c summing column c over
//     the cluster's rows in index order as JAX's loop visits them, so the
//     sums are deterministic;
//  6. the fused rows sorted by descending fused score (ties in emission
//     order: a stable sort) and written, then the padding.
// Every product and sum of the fusion and the IoU is an explicitly
// rounded intrinsic, so nvcc contracts nothing into an FMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "iou_test.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxRows = 1024;          // 32 alive words, one a lane
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float half_max(float v) {   // over 16 lanes
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  }
  return v;
}

__host__ __device__ __forceinline__ int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// A 64-bit key that sorts by descending score, then ascending index
// (-0 as +0; an invalid row's -inf after every finite score).
__device__ __forceinline__ unsigned long long order_key(float s, int i) {
  unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);     // ascending in s
  return ((unsigned long long)~u << 32) | (unsigned)i;
}

__device__ __forceinline__ unsigned long long shfl_xor64(
    unsigned long long v, int j) {
  const unsigned lo = __shfl_xor_sync(~0u, (unsigned)v, j);
  const unsigned hi = __shfl_xor_sync(~0u, (unsigned)(v >> 32), j);
  return ((unsigned long long)hi << 32) | lo;
}

// One compare-exchange of a bitonic network: element i of a k-run, its
// partner j away.
__device__ __forceinline__ unsigned long long bitonic_step(
    unsigned long long v, unsigned long long other, int i, int j, int k) {
  const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
  return keep_min ? (v < other ? v : other) : (v < other ? other : v);
}

// Ascending bitonic sort of key[0, n), n a power of two up to 2 kThreads,
// by the block. Each thread holds key[tid] (and key[tid + kThreads] when
// n is larger) in registers: partners less than 32 apart meet by
// shuffles, partners in other warps through shared memory (two barriers),
// a thread's two elements in its registers. The caller has synchronised
// after writing the keys; they are sorted in key[] on return.
__device__ void bitonic_sort(unsigned long long* key, int n) {
  const int tid = threadIdx.x;
  const bool two = n > kThreads;
  const bool on = tid < (n > 32 ? n : 32);      // whole warps
  unsigned long long v0 = on && tid < n ? key[tid] : ~0ULL;
  unsigned long long v1 = two ? key[tid + kThreads] : ~0ULL;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= kThreads) {                      // tid and tid + kThreads
        const unsigned long long lo = v0 < v1 ? v0 : v1;
        v1 = v0 < v1 ? v1 : v0;
        v0 = lo;
      } else if (j >= 32) {
        __syncthreads();
        if (on) key[tid] = v0;
        if (two) key[tid + kThreads] = v1;
        __syncthreads();
        if (on) v0 = bitonic_step(v0, key[tid ^ j], tid, j, k);
        if (two) {
          v1 = bitonic_step(v1, key[(tid + kThreads) ^ j], tid + kThreads,
                            j, k);
        }
      } else if (on) {
        v0 = bitonic_step(v0, shfl_xor64(v0, j), tid, j, k);
        if (two) {
          v1 = bitonic_step(v1, shfl_xor64(v1, j), tid + kThreads, j, k);
        }
      }
    }
  }
  __syncthreads();
  if (on && tid < n) key[tid] = v0;
  if (two) key[tid + kThreads] = v1;
  __syncthreads();
}

// The triangle of mask words over W = ceil(rows / 32) words a row: row r
// holds the words r / 32 .. W - 1.
__host__ __device__ __forceinline__ long long mask_words(int rows) {
  const long long w = (rows + 31) / 32;
  return 16 * w * (w + 1);
}
__device__ __forceinline__ int mask_row(int r, int w) {
  const int t = r >> 5;
  return 32 * (t * w - t * (t - 1) / 2) + (r & 31) * (w - t);
}

// Shared memory in 4-byte words: the rows (boxes and sorted offset boxes,
// 4 each; score, class, sorted-to-row index, cluster, seed, sorted box's
// area: 1 each; the probs), reduction slots, then one region that holds
// the mask and later the fused rows (box 4, score, class: 1 each, probs).
// At n = 1024 it takes n (20 + 2 (C+1)) words and 256 bytes: up to
// C+1 = 18 probs a row.
struct Layout {
  long long box, sort, score, cls, perm, owner, seeds, area, prob, misc,
      region, total;
};

__host__ __device__ __forceinline__ Layout layout(int n, int c1) {
  Layout l;
  l.box = 0;
  l.sort = 4LL * n;
  l.score = 8LL * n;
  l.cls = l.score + n;
  l.perm = l.cls + n;
  l.owner = l.perm + n;
  l.seeds = l.owner + n;
  l.area = l.seeds + n;
  l.prob = l.area + n;
  l.misc = l.prob + (long long)n * c1;
  l.region = (l.misc + 64 + 3) / 4 * 4;
  const long long fused = 6LL * n + (long long)n * c1;
  const long long mask = mask_words(n);
  l.total = l.region + (fused > mask ? fused : mask);
  return l;
}

__global__ void __launch_bounds__(kThreads)
fusion_nms_kernel(const float* __restrict__ boxes,
                  const float* __restrict__ probs,
                  const int* __restrict__ classes,
                  const uint8_t* __restrict__ valid, float* __restrict__ o_box,
                  float* __restrict__ o_score, float* __restrict__ o_prob,
                  int* __restrict__ o_cls, uint8_t* __restrict__ o_valid,
                  int n, int c1, float thr, float h, float umin, int fast,
                  int score_method, int box_method) {
  extern __shared__ __align__(16) float sm[];
  const Layout lay = layout(n, c1);
  float4* sbox = reinterpret_cast<float4*>(sm + lay.box);
  float4* ssort = reinterpret_cast<float4*>(sm + lay.sort);
  float* sscore = sm + lay.score;
  int* scls = reinterpret_cast<int*>(sm + lay.cls);
  int* perm = reinterpret_cast<int*>(sm + lay.perm);
  int* owner = reinterpret_cast<int*>(sm + lay.owner);
  int* seeds = reinterpret_cast<int*>(sm + lay.seeds);
  float* sarea = sm + lay.area;
  float* sprob = sm + lay.prob;
  float* misc = sm + lay.misc;
  int* imisc = reinterpret_cast<int*>(misc);
  float4* ubox = reinterpret_cast<float4*>(sm + lay.region);
  float* uscore = sm + lay.region + 4LL * n;
  int* ucls = reinterpret_cast<int*>(uscore + n);
  float* uprob = reinterpret_cast<float*>(ucls + n);

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (size_t)b * n;
  unsigned* mask = reinterpret_cast<unsigned*>(sm + lay.region);

  // 1. set-up
  float m = -INFINITY;
  int nv = 0, ne = 0;       // valid rows; of them, with a score > NEG_INF/2
  for (int r = tid; r < n; r += kThreads) {
    const bool v = valid[row0 + r] != 0;
    const float4 bx = reinterpret_cast<const float4*>(boxes)[row0 + r];
    const int cl = classes[row0 + r];
    sbox[r] = bx;
    scls[r] = cl;
    owner[r] = -1;                // no cluster (yet)
    m = fmaxf(m, v ? fmaxf(fmaxf(bx.x, bx.y), fmaxf(bx.z, bx.w)) : 0.0f);
    const float s = v ? probs[(row0 + r) * c1 + min(max(cl, 0), c1 - 1)]
                      : -INFINITY;
    sscore[r] = s;
    nv += v;
    ne += v && s > kNegInf * 0.5f;
  }
  for (long long i = tid; i < (long long)n * c1; i += kThreads) {
    sprob[i] = probs[row0 * c1 + i];
  }
  m = warp_max(m);
  for (int o = 16; o > 0; o >>= 1) {
    nv += __shfl_xor_sync(~0u, nv, o);
    ne += __shfl_xor_sync(~0u, ne, o);
  }
  if (lane == 0) {
    misc[warp] = m;
    imisc[kWarps + warp] = nv;
    imisc[2 * kWarps + warp] = ne;
  }
  __syncthreads();
  m = -INFINITY;
  nv = ne = 0;
  for (int w = 0; w < kWarps; ++w) {
    m = fmaxf(m, misc[w]);
    nv += imisc[kWarps + w];
    ne += imisc[2 * kWarps + w];
  }
  const float step = __fadd_rn(m, 1.0f);
  // the valid rows by descending score, ties by index (the sorted boxes'
  // space holds the keys until then)
  unsigned long long* key = reinterpret_cast<unsigned long long*>(ssort);
  const int npow = pow2_at_least(n);
  for (int i = tid; i < npow; i += kThreads) {
    key[i] = i < n ? order_key(sscore[i], i) : ~0ULL;
  }
  __syncthreads();
  bitonic_sort(key, npow);
  for (int r = tid; r < nv; r += kThreads) {
    perm[r] = (int)(key[r] & 0xffffffffu);
  }
  __syncthreads();
  for (int r = tid; r < nv; r += kThreads) {
    const int i = perm[r];
    const float shift = __fmul_rn((float)max(scls[i], 0), step);
    const float4 bx = sbox[i];
    ssort[r] = make_float4(__fadd_rn(bx.x, shift), __fadd_rn(bx.y, shift),
                           __fadd_rn(bx.z, shift), __fadd_rn(bx.w, shift));
    sarea[r] = iou_test::area(ssort[r], 1.0f);
  }
  __syncthreads();

  // 2. the mask of the sorted valid rows, row r over the columns c > r,
  // K3's way (csrc/nms.cu): a warp per (row tile, column word) on or
  // above the diagonal, a lane per row, its 32 tests unrolled and
  // branch-free against column boxes that every lane reads at once; the
  // pairs the division-free test (iou_test.cuh) cannot decide divide
  // after the loop
  const int W = (nv + 31) / 32;
  const iou_test::Split split = iou_test::make_split(thr, h, umin, fast);
  for (int unit = warp; unit < W * (W + 1) / 2; unit += kWarps) {
    int t = 0, wi = unit;
    while (wi >= W - t) {
      wi -= W - t;
      ++t;
    }
    wi += t;
    const int r = 32 * t + lane, c0 = 32 * wi;
    const float4 a = ssort[min(r, nv - 1)];
    const float aa = iou_test::area(a, 1.0f);
    unsigned bits = 0u, slow = 0u;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = min(c0 + j, nv - 1);
      const float inter = iou_test::intersection<true>(a, ssort[c]);
      const float uni = iou_test::union_of(aa, sarea[c], inter);
      const bool in = iou_test::decides(uni, split);
      bits |= (unsigned)(in && iou_test::exceeds(inter, uni, split)) << j;
      slow |= (unsigned)(!in && uni > 0.0f) << j;
    }
    // the columns c with r < c < nv
    const int lo = r + 1 - c0, hi = nv - c0;
    unsigned live = hi >= 32 ? ~0u : (1u << max(hi, 0)) - 1u;
    live &= lo <= 0 ? ~0u : lo >= 32 ? 0u : ~0u << lo;
    bits &= live;
    slow &= live;
    if (0.0f > thr) bits |= live & ~slow;   // union <= 0 counts as IoU 0
    for (; slow != 0u; slow &= slow - 1u) {
      const int c = c0 + __ffs(slow) - 1;
      const float inter = iou_test::intersection<true>(a, ssort[c]);
      const float uni = iou_test::union_of(aa, sarea[c], inter);
      if (iou_test::exceeds_by_division(inter, uni, thr)) {
        bits |= 1u << (c - c0);
      }
    }
    if (r < nv) mask[mask_row(r, W) + wi - t] = bits;
  }
  __syncthreads();

  // 3. the sweep, a tile of 32 sorted rows at a time. Lane w holds the
  // alive word w. In the tile only the rows whose diagonal word is not
  // empty can take another row of the tile: the warp steps through those
  // in order (the word from a shuffle); one still alive is a seed, its
  // cluster the alive bits of its word and itself. The rows alive after
  // that are seeds of their own. Each lane notes the cluster of its row.
  // Then each later word loads the words of the tile's rows at once and,
  // where they reach one of its alive rows, drops the seeds' clusters in
  // seed order, marking the rows it drops.
  if (warp == 0) {
    unsigned alive = 0u;
    if (lane < W) {
      const int left = nv - lane * 32;
      alive = left >= 32 ? ~0u : (1u << left) - 1u;
    }
    int k = 0;
    for (int t = 0; t < W; ++t) {
      const int r = t * 32 + lane;
      const int last = min(31, nv - 1 - t * 32);     // the tile's last row
      const unsigned diag = mask[mask_row(t * 32 + min(lane, last), W)];
      const int lim = ne - t * 32;                   // rows below it may seed
      const unsigned may = lim >= 32 ? ~0u : (1u << max(lim, 0)) - 1u;
      unsigned a = __shfl_sync(~0u, alive, t);
      unsigned tile_seeds = 0u;
      int killer = -1;                 // the seed whose cluster takes my row
      for (unsigned sup = __ballot_sync(~0u, lane <= last && diag != 0u);
           sup != 0u; sup &= sup - 1u) {
        const int i = __ffs(sup) - 1;
        const unsigned d = __shfl_sync(~0u, diag, i);
        if ((a & may) >> i & 1u) {
          const unsigned cl = a & (d | (1u << i));
          a &= ~cl;
          if ((cl >> lane) & 1u) killer = i;
          tile_seeds |= 1u << i;
        }
      }
      const unsigned rest = a & may;   // alive, taking no other row
      tile_seeds |= rest;
      if ((rest >> lane) & 1u) killer = lane;
      if (killer >= 0) {
        owner[perm[r]] = k + __popc(tile_seeds & ((1u << killer) - 1u));
      }
      if ((tile_seeds >> lane) & 1u) {
        seeds[k + __popc(tile_seeds & ((1u << lane) - 1u))] = perm[r];
      }
      if (lane > t && lane < W) {
        const int base = 32 * (t * W - t * (t - 1) / 2) + lane - t;
        unsigned sw[32], drop = 0u;       // the seeds' words
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sw[i] = mask[base + min(i, last) * (W - t)] &
                 (0u - ((tile_seeds >> i) & 1u));
          drop |= sw[i];
        }
        if (alive & drop) {
          int kw = k;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const unsigned hit = alive & sw[i];
            alive &= ~hit;
            for (unsigned bb = hit; bb != 0u; bb &= bb - 1u) {
              owner[perm[lane * 32 + __ffs(bb) - 1]] = kw;
            }
            kw += (int)((tile_seeds >> i) & 1u);
          }
        }
      }
      k += __popc(tile_seeds);
      if (lim <= 32) break;            // no row after the tile may seed
    }
    if (lane == 0) imisc[3 * kWarps] = k;
  }
  __syncthreads();
  const int K = imisc[3 * kWarps];

  // 4. each cluster's rows in index order: a bitonic sort of (cluster,
  // row) keys (the sorted boxes' space holds them); the sorted-to-row
  // index takes the rows, the rows' cluster numbers each cluster's end
  unsigned long long* gkey = reinterpret_cast<unsigned long long*>(ssort);
  for (int i = tid; i < npow; i += kThreads) {
    const int o = i < n ? owner[i] : -1;
    gkey[i] = o >= 0 ? ((unsigned long long)o << 32) | (unsigned)i : ~0ULL;
  }
  __syncthreads();
  bitonic_sort(gkey, npow);
  int* list = perm;
  int* end = owner;
  for (int p = tid; p < n; p += kThreads) {
    const unsigned long long g = gkey[p];
    if (g == ~0ULL) continue;
    list[p] = (int)(g & 0xffffffffu);
    if (p + 1 == n || gkey[p + 1] >> 32 != g >> 32) end[g >> 32] = p + 1;
  }
  __syncthreads();                // the mask is dead: the fused rows follow

  // 5. the fusion, half a warp per cluster, two clusters a warp in step
  const int half = lane >> 4, hl = lane & 15;
  for (int kb = 2 * warp; kb < K; kb += 2 * kWarps) {
    const int k = kb + half;
    const bool on = k < K;
    const int stop_at = on ? end[k] : 0;
    const int csz = on ? stop_at - (k > 0 ? end[k - 1] : 0) : 0;
    const int top = on ? seeds[k] : 0;
    const float count = (float)max(csz, 1);
    // Σ over the cluster's rows in index order of f(row)
#define CLUSTER_SUM(acc, expr)                                   \
    for (int i_ = stop_at - csz; i_ < stop_at; ++i_) {           \
      const int r = list[i_];                                    \
      acc = __fadd_rn(acc, (expr));                              \
    }

    float* fprob = uprob + (size_t)(on ? k : 0) * c1;
    const int fcls = scls[top];
    if (score_method == 0) {                     // probEn
      float mx = -INFINITY;
      for (int c = hl; c < c1; c += 16) {
        float s = 0.0f;
        CLUSTER_SUM(s, logf(fmaxf(sprob[r * c1 + c], 1e-20f)));
        if (on) fprob[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = half_max(mx);
      float tot = 0.0f;
      for (int c = hl; c < c1; c += 16) {
        const float e = expf(__fsub_rn(on ? fprob[c] : mx, mx));
        if (on) fprob[c] = e;
        tot = __fadd_rn(tot, e);
      }
      tot = half_sum(tot);
      for (int c = hl; c < c1; c += 16) {
        if (on) fprob[c] = __fdiv_rn(fprob[c], tot);
      }
    } else if (score_method == 1) {              // avg
      for (int c = hl; c < c1; c += 16) {
        float s = 0.0f;
        CLUSTER_SUM(s, sprob[r * c1 + c]);
        if (on) fprob[c] = __fdiv_rn(s, count);
      }
    } else {                                     // max: the seed's row
      for (int c = hl; c < c1; c += 16) {
        if (on) fprob[c] = sprob[top * c1 + c];
      }
    }
    float wsum = 0.0f;                           // Σ of the cluster's scores
    CLUSTER_SUM(wsum, sscore[r]);
    __syncwarp();
    if (on && hl == 0) {
      float fscore;
      if (score_method == 0) {
        fscore = fprob[min(max(fcls, 0), c1 - 1)];
      } else if (score_method == 1) {
        fscore = __fdiv_rn(wsum, count);
      } else {
        fscore = sscore[top];
      }
      uscore[k] = fscore;
      ucls[k] = fcls;
    }
    float fb = 0.0f;
    if (hl < 4) {
      const float* sb = reinterpret_cast<const float*>(sbox);
      if (box_method == 0) {                     // s-avg
        const float denom = fmaxf(wsum, 1e-20f);
        CLUSTER_SUM(fb, __fmul_rn(sb[r * 4 + hl],
                                  __fdiv_rn(sscore[r], denom)));
      } else if (box_method == 1) {              // avg
        CLUSTER_SUM(fb, sb[r * 4 + hl]);
        fb = __fdiv_rn(fb, count);
      } else {                                   // max: the seed's box
        fb = sb[top * 4 + hl];
      }
    }
#undef CLUSTER_SUM
    const int h0 = lane & 16;
    const float f1 = __shfl_sync(~0u, fb, h0 + 1);
    const float f2 = __shfl_sync(~0u, fb, h0 + 2);
    const float f3 = __shfl_sync(~0u, fb, h0 + 3);
    if (on && hl == 0) ubox[k] = make_float4(fb, f1, f2, f3);
    __syncwarp();
  }
  __syncthreads();

  // 6. the fused rows by descending fused score, ties in emission order
  // (the counting sort's space holds the keys), then the padding
  unsigned long long* fkey = reinterpret_cast<unsigned long long*>(ssort);
  const int kpow = pow2_at_least(K);
  for (int i = tid; i < kpow; i += kThreads) {
    fkey[i] = i < K ? order_key(uscore[i], i) : ~0ULL;
  }
  __syncthreads();
  bitonic_sort(fkey, kpow);
  for (int p = tid; p < K; p += kThreads) {
    const int k = (int)(fkey[p] & 0xffffffffu);
    const size_t o = row0 + p;
    reinterpret_cast<float4*>(o_box)[o] = ubox[k];
    o_score[o] = uscore[k];
    o_cls[o] = ucls[k];
    o_valid[o] = 1;
  }
  for (long long i = tid; i < (long long)K * c1; i += kThreads) {
    const int p = (int)(i / c1), c = (int)(i - (long long)p * c1);
    const int k = (int)(fkey[p] & 0xffffffffu);
    o_prob[row0 * c1 + i] = uprob[(size_t)k * c1 + c];
  }
  for (int r = K + tid; r < n; r += kThreads) {
    reinterpret_cast<float4*>(o_box)[row0 + r] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    o_score[row0 + r] = 0.0f;
    o_cls[row0 + r] = -1;
    o_valid[row0 + r] = 0;
  }
  for (long long i = (long long)K * c1 + tid; i < (long long)n * c1;
       i += kThreads) {
    o_prob[row0 * c1 + i] = 0.0f;
  }
}

unsigned long long configured = 0;   // devices whose attribute is set

}  // namespace

// boxes (batch, n, 4) f32, probs (batch, n, c1) f32, classes (batch, n)
// int32, valid (batch, n) u8 → o_box, o_score, o_prob, o_cls, o_valid of
// the same shapes; thr, h, umin and fast: the IoU threshold's split
// (ops/nms.threshold_split). score_method 0 probEn / 1 avg / 2 max;
// box_method 0 s-avg / 1 avg / 2 max. Returns the CUDA error code of the
// launch.
extern "C" int coin_fusion_nms(const void* boxes, const void* probs,
                               const void* classes, const void* valid,
                               void* o_box, void* o_score, void* o_prob,
                               void* o_cls, void* o_valid, int batch,
                               int n, int c1, float thr, float h,
                               float umin, int fast, int score_method,
                               int box_method, void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxRows || c1 <= 0 || score_method < 0 ||
      score_method > 2 || box_method < 0 || box_method > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem = layout(n, c1).total * 4;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (smem > 48 * 1024 && !(configured & bit)) {
    err = cudaFuncSetAttribute(fusion_nms_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured |= bit;
  }
  fusion_nms_kernel<<<batch, kThreads, (size_t)smem,
                      (cudaStream_t)stream>>>(
      (const float*)boxes, (const float*)probs, (const int*)classes,
      (const uint8_t*)valid, (float*)o_box, (float*)o_score, (float*)o_prob,
      (int*)o_cls, (uint8_t*)o_valid, n, c1, thr, h, umin, fast,
      score_method, box_method);
  return (int)cudaGetLastError();
}

// Shared memory of one launch in bytes (over 227 KB: refused).
extern "C" long long coin_fusion_nms_smem(int n, int c1) {
  return layout(n, c1).total * 4;
}
