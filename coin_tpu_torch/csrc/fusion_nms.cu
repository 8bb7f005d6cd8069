// K6 · Probabilistic-Fusion greedy NMS for Hopper, one image per block.
//
// Replaces: coin_tpu/ops/nms.py `fusion_nms` (:137-224), a `fori_loop`
// of masked vector ops over the N rows of one image, vmapped over the
// batch; the reference's `nms_bayesian` (coin/layers/nms.py:84-194).
//
// Input per image: N rows of boxes (N, 4) f32 xyxy, probs (N, C+1) f32,
// classes (N,) int32 and valid (N,) u8; the IoU threshold; the score
// method (0 probEn, 1 avg, 2 max) and box method (0 s-avg, 1 avg, 2 max).
// Output: N fused rows (boxes, scores, probs, classes, valid), valid rows
// first by descending fused score (stable on ties), the rest zero with
// class -1.
//
// Computes, as JAX does: the class offset (max coordinate over the valid
// rows and zeros, + 1, times the class), the seed score probs[class];
// then repeatedly the seed (the highest alive score, the lowest index on
// ties), its cluster (alive rows whose +1 IoU with the seed exceeds the
// threshold, and the seed), the fused probs (probEn: softmax of the summed
// log(max(p, 1e-20)); avg: mean; max: the seed's row), the fused score and
// class, the fused box (s-avg: weights score / max(Σ score, 1e-20); avg:
// mean; max: the seed's box; the `max(csz, 1)` guards), until no row is
// alive; finally a stable sort by descending fused score. (For 'max' the
// cluster's argmax is the seed itself: the cluster is a subset of the
// alive rows, of which the seed is the first with the highest score.)
//
// Bound: the serial chain of N cluster steps, not bytes or operations:
// 4 x 256 rows of 9 classes are 50 KB in and out, a few hundred thousand
// operations. Design: one warp per image, so that each step's reductions
// are warp shuffles and no step waits on a block barrier: each lane owns
// the rows lane, lane + 32, ... (at most 32, an `alive` bit each in one
// register); the argmax and the IoUs run across lanes; the cluster's
// rows are gathered into bit words with `__ballot_sync`, and lane c sums
// column c over the cluster's rows in index order, so the sums are
// deterministic. Rows, their logs and the emitted rows sit in shared
// memory. Every product and sum is an explicitly rounded intrinsic, so
// nvcc contracts nothing into an FMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxRows = 1024;          // 32 rows per lane
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float iou_plus1(const float* a, const float* b) {
  float w = fmaxf(__fadd_rn(__fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])),
                            1.0f), 0.0f);
  float h = fmaxf(__fadd_rn(__fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])),
                            1.0f), 0.0f);
  float inter = __fmul_rn(w, h);
  float area_a = __fmul_rn(__fadd_rn(__fsub_rn(a[2], a[0]), 1.0f),
                           __fadd_rn(__fsub_rn(a[3], a[1]), 1.0f));
  float area_b = __fmul_rn(__fadd_rn(__fsub_rn(b[2], b[0]), 1.0f),
                           __fadd_rn(__fsub_rn(b[3], b[1]), 1.0f));
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  }
  return v;
}

size_t smem_bytes(int n, int c1) {
  const size_t words = (size_t)(n + 31) / 32;
  return sizeof(float) * ((size_t)n * (16 + 3 * (size_t)c1) + c1) +
         sizeof(unsigned) * words;
}

__global__ void __launch_bounds__(32)
fusion_nms_kernel(const float* __restrict__ boxes,
                  const float* __restrict__ probs,
                  const int* __restrict__ classes,
                  const uint8_t* __restrict__ valid, float* __restrict__ o_box,
                  float* __restrict__ o_score, float* __restrict__ o_prob,
                  int* __restrict__ o_cls, uint8_t* __restrict__ o_valid,
                  int n, int c1, float thr, int score_method,
                  int box_method) {
  extern __shared__ float sm[];
  float* sbox = sm;                          // n x 4 boxes
  float* soff = sbox + n * 4;                // n x 4 class-offset boxes
  float* sscore = soff + n * 4;              // n seed scores
  float* sprob = sscore + n;                 // n x c1 probs
  float* slogp = sprob + n * c1;             // n x c1 log(max(p, 1e-20))
  float* ubox = slogp + n * c1;              // emitted rows: n x 4
  float* uscore = ubox + n * 4;              // n
  float* uprob = uscore + n;                 // n x c1
  int* ucls = reinterpret_cast<int*>(uprob + n * c1);   // n
  int* scls = ucls + n;                      // n input classes
  float* ssum = reinterpret_cast<float*>(scls + n);      // c1 scratch
  unsigned* cwords = reinterpret_cast<unsigned*>(ssum + c1);

  const int b = blockIdx.x, lane = threadIdx.x;
  const int words = (n + 31) / 32;
  const float* bb = boxes + (size_t)b * n * 4;
  const float* pb = probs + (size_t)b * n * c1;

  unsigned alive = 0;
  float m = -INFINITY;
  for (int j = 0, r = lane; r < n; ++j, r += 32) {
    const bool v = valid[(size_t)b * n + r] != 0;
    scls[r] = classes[(size_t)b * n + r];
    for (int i = 0; i < 4; ++i) {
      const float x = bb[r * 4 + i];
      sbox[r * 4 + i] = x;
      m = fmaxf(m, v ? x : 0.0f);
    }
    for (int c = 0; c < c1; ++c) {
      const float p = pb[(size_t)r * c1 + c];
      sprob[r * c1 + c] = p;
      slogp[r * c1 + c] = logf(fmaxf(p, 1e-20f));
    }
    if (v) alive |= 1u << j;
  }
  m = warp_max(m);
  const float step = __fadd_rn(m, 1.0f);
  for (int j = 0, r = lane; r < n; ++j, r += 32) {
    const bool v = (alive >> j) & 1u;
    const int cl = min(max(scls[r], 0), c1 - 1);
    const float shift = __fmul_rn((float)max(scls[r], 0), step);
    for (int i = 0; i < 4; ++i) {
      soff[r * 4 + i] = v ? __fadd_rn(sbox[r * 4 + i], shift) : 0.0f;
    }
    sscore[r] = v ? sprob[r * c1 + cl] : kNegInf;
  }
  __syncwarp();

  int k = 0;
  for (; k < n; ++k) {
    // the seed: the highest alive score, the lowest index on ties
    float best = kNegInf;
    int top = 0;
    for (int j = 0, r = lane; r < n; ++j, r += 32) {
      const float v = ((alive >> j) & 1u) ? sscore[r] : kNegInf;
      if (v > best) {
        best = v;
        top = r;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(~0u, best, o);
      const int ot = __shfl_xor_sync(~0u, top, o);
      if (ob > best || (ob == best && ot < top)) {
        best = ob;
        top = ot;
      }
    }
    if (!(best > kNegInf * 0.5f)) break;

    // its cluster, as bit words in row order
    const float* seed = soff + top * 4;
    unsigned cl = 0;
    for (int j = 0, r = lane; r < n; ++j, r += 32) {
      if (((alive >> j) & 1u) &&
          (r == top || iou_plus1(seed, soff + r * 4) > thr)) {
        cl |= 1u << j;
      }
    }
    int csz = 0;
    for (int j = 0; j < words; ++j) {
      const unsigned w = __ballot_sync(~0u, (cl >> j) & 1u);
      if (lane == 0) cwords[j] = w;
      csz += __popc(w);
    }
    alive &= ~cl;
    __syncwarp();
    const float count = (float)max(csz, 1);
    // Σ over the cluster's rows in index order of f(row)
#define CLUSTER_SUM(acc, expr)                                   \
    for (int j_ = 0; j_ < words; ++j_) {                         \
      for (unsigned w_ = cwords[j_]; w_; w_ &= w_ - 1) {         \
        const int r = j_ * 32 + __ffs(w_) - 1;                   \
        acc = __fadd_rn(acc, (expr));                            \
      }                                                          \
    }

    float* fprob = uprob + (size_t)k * c1;
    int fcls = scls[top];
    if (score_method == 0) {                     // probEn
      float mx = -INFINITY;
      for (int c = lane; c < c1; c += 32) {
        float s = 0.0f;
        CLUSTER_SUM(s, slogp[r * c1 + c]);
        ssum[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      float tot = 0.0f;
      for (int c = lane; c < c1; c += 32) {
        const float e = expf(__fsub_rn(ssum[c], mx));
        ssum[c] = e;
        tot = __fadd_rn(tot, e);
      }
      tot = warp_sum(tot);
      for (int c = lane; c < c1; c += 32) fprob[c] = __fdiv_rn(ssum[c], tot);
    } else if (score_method == 1) {              // avg
      for (int c = lane; c < c1; c += 32) {
        float s = 0.0f;
        CLUSTER_SUM(s, sprob[r * c1 + c]);
        fprob[c] = __fdiv_rn(s, count);
      }
    } else {                                     // max: the seed's row
      for (int c = lane; c < c1; c += 32) fprob[c] = sprob[top * c1 + c];
    }
    float wsum = 0.0f;                           // Σ of the cluster's scores
    CLUSTER_SUM(wsum, sscore[r]);
    __syncwarp();
    if (lane == 0) {
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
    if (lane < 4) {
      float fb = 0.0f;
      if (box_method == 0) {                     // s-avg
        const float denom = fmaxf(wsum, 1e-20f);
        CLUSTER_SUM(fb, __fmul_rn(sbox[r * 4 + lane],
                                  __fdiv_rn(sscore[r], denom)));
      } else if (box_method == 1) {              // avg
        CLUSTER_SUM(fb, sbox[r * 4 + lane]);
        fb = __fdiv_rn(fb, count);
      } else {                                   // max: the seed's box
        fb = sbox[top * 4 + lane];
      }
      ubox[k * 4 + lane] = fb;
    }
#undef CLUSTER_SUM
    __syncwarp();
  }

  // the emitted rows by descending fused score, stable, then padding
  const int emitted = k;
  const size_t ob = (size_t)b * n;
  for (int r = lane; r < emitted; r += 32) {
    const float s = uscore[r];
    int rank = 0;
    for (int j = 0; j < emitted; ++j) {
      const float sj = uscore[j];
      rank += (sj > s) || (sj == s && j < r);
    }
    for (int i = 0; i < 4; ++i) o_box[(ob + rank) * 4 + i] = ubox[r * 4 + i];
    for (int c = 0; c < c1; ++c) {
      o_prob[(ob + rank) * c1 + c] = uprob[(size_t)r * c1 + c];
    }
    o_score[ob + rank] = s;
    o_cls[ob + rank] = ucls[r];
    o_valid[ob + rank] = 1;
  }
  for (int r = emitted + lane; r < n; r += 32) {
    for (int i = 0; i < 4; ++i) o_box[(ob + r) * 4 + i] = 0.0f;
    for (int c = 0; c < c1; ++c) o_prob[(ob + r) * c1 + c] = 0.0f;
    o_score[ob + r] = 0.0f;
    o_cls[ob + r] = -1;
    o_valid[ob + r] = 0;
  }
}

}  // namespace

// boxes (batch, n, 4) f32, probs (batch, n, c1) f32, classes (batch, n)
// int32, valid (batch, n) u8 → o_box, o_score, o_prob, o_cls, o_valid of
// the same shapes. score_method 0 probEn / 1 avg / 2 max; box_method 0
// s-avg / 1 avg / 2 max. Returns the CUDA error code of the launch.
extern "C" int coin_fusion_nms(const void* boxes, const void* probs,
                               const void* classes, const void* valid,
                               void* o_box, void* o_score, void* o_prob,
                               void* o_cls, void* o_valid, int batch, int n,
                               int c1, float thr, int score_method,
                               int box_method, void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxRows || c1 <= 0 || score_method < 0 ||
      score_method > 2 || box_method < 0 || box_method > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(n, c1);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fusion_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fusion_nms_kernel<<<batch, 32, smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const float*)probs, (const int*)classes,
      (const uint8_t*)valid, (float*)o_box, (float*)o_score, (float*)o_prob,
      (int*)o_cls, (uint8_t*)o_valid, n, c1, thr, score_method, box_method);
  return (int)cudaGetLastError();
}

extern "C" long long coin_fusion_nms_smem(int n, int c1) {
  return (long long)smem_bytes(n, c1);
}
