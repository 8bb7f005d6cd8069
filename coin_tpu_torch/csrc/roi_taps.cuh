// The bilinear taps of RoIAlign (aligned=True, static sampling ratio),
// shared by K1 (csrc/roi_align.cu) and K1b (csrc/roi_align_bwd.cu).
//
// Semantics (coin_tpu/ops/roi_align.py:28-95): roi * scale - 0.5; sample
// k of cell r at start + (r + (k + 0.5) / s) * bin; a sample outside
// [-1, size] weighs 0; inside, it is clamped to [0, size - 1] and split
// between its two neighbouring grid lines. Every coordinate is computed
// with explicitly rounded intrinsics in the JAX op's order: a contracted
// FMA would move a coordinate by an ulp and a tap weight by ~1e-5 at the
// far edge.

#pragma once

#include <cuda_runtime.h>

namespace roi_taps {

struct Tap {
  int lo, hi;       // neighbouring grid rows (or columns)
  float wlo, whi;   // their weights
  bool in;          // false when the sample is outside [-1, size]: weight 0
};

__device__ __forceinline__ Tap make_tap(float pos, int size) {
  Tap t;
  if (pos < -1.0f || pos > (float)size) {
    t.lo = 0; t.hi = 0; t.wlo = 0.0f; t.whi = 0.0f; t.in = false;
    return t;
  }
  const float p = fminf(fmaxf(pos, 0.0f), (float)(size - 1));
  const int lo = (int)floorf(p);
  t.lo = lo;
  t.hi = min(lo + 1, size - 1);
  // the tent weights 1 - |p - g| of the JAX op and the plain version at
  // g = lo and lo + 1, rounded as they round them
  t.wlo = __fsub_rn(1.0f, __fsub_rn(p, (float)lo));
  t.whi = __fsub_rn(1.0f, __fsub_rn((float)(lo + 1), p));
  t.in = true;
  return t;
}

// The RoI on the feature grid: its start and bin along x and y.
struct Frame {
  float x1, y1, bin_w, bin_h;
};

__device__ __forceinline__ Frame frame(const float* r4, float spatial_scale,
                                       int res) {
  Frame f;
  f.x1 = __fsub_rn(__fmul_rn(r4[0], spatial_scale), 0.5f);
  f.y1 = __fsub_rn(__fmul_rn(r4[1], spatial_scale), 0.5f);
  const float x2 = __fsub_rn(__fmul_rn(r4[2], spatial_scale), 0.5f);
  const float y2 = __fsub_rn(__fmul_rn(r4[3], spatial_scale), 0.5f);
  f.bin_w = __fdiv_rn(__fsub_rn(x2, f.x1), (float)res);
  f.bin_h = __fdiv_rn(__fsub_rn(y2, f.y1), (float)res);
  return f;
}

// The tap of sample k (of s) of cell r along one axis.
__device__ __forceinline__ Tap sample_tap(float start, float bin, int r,
                                          int k, int s, int size) {
  const float off = __fdiv_rn((float)k + 0.5f, (float)s);
  return make_tap(__fadd_rn(start, __fmul_rn(__fadd_rn((float)r, off), bin)),
                  size);
}

}  // namespace roi_taps
