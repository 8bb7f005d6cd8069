// The IoU test without the division, shared by K3 (csrc/nms.cu: suppress
// when IoU > thr), K6 (csrc/fusion_nms.cu: cluster when the +1 IoU > thr)
// and K11 (csrc/dedup.cu: join when IoU >= thr, decided as IoU > thr-, the
// f32 just below thr, since a rounded quotient is >= thr exactly when it
// is > thr-).
//
// IoU (coin_tpu/ops/boxes.py:28-48): half-open or inclusive (+1) widths,
// iou = union > 0 ? inter / union : 0. Every product and sum is an
// explicitly rounded intrinsic, so the compiler contracts nothing into an
// FMA and inter and union equal those of the plain PyTorch version to the
// bit.
//
// The test: fl(inter / union) > thr where union > 0, else 0 > thr, bit for
// bit the plain version's. The quotient's rounding is monotone, so it
// exceeds thr exactly when inter / union exceeds m = thr + h, the midpoint
// between thr and the next float (ops/nms.threshold_split). With
// r = fma(-thr, union, inter), rounded once, r > h * union implies
// inter - thr * union > h * union, and r < h * union the converse, since
// h * union is exact (h a power of two, union in [umin, 2^100]) and rounding
// is monotone. r never equals h * union there: their difference is a
// nonzero multiple of h * union's ulp (m needs 25 significant bits, so
// m * union is no f32). Unions outside that range, and thresholds outside
// (0, 1] (fast = 0), are not decided: the caller divides for those with a
// union above 0 (`exceeds_by_division`) and sets the rest to 0 > thr.

#pragma once

#include <cuda_runtime.h>

namespace iou_test {

// The threshold's split (ops/nms.threshold_split): the unions in
// [umin, umax] are decided, none when fast is 0.
struct Split {
  float thr, h, umin, umax;
};

__host__ __device__ inline Split make_split(float thr, float h, float umin,
                                             int fast) {
  return Split{thr, h, umin, fast ? 0x1p100f : -1.0f};
}

// A box's area with half-open (off 0) or inclusive (off 1) widths.
__device__ __forceinline__ float area(const float4 b, float off) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), off),
                   __fadd_rn(__fsub_rn(b.w, b.y), off));
}

// The overlap of two boxes along one axis: half-open or inclusive (+1)
// widths, never below 0.
template <bool kPlus1>
__device__ __forceinline__ float side(float lo0, float hi0, float lo1,
                                      float hi1) {
  float d = __fsub_rn(fminf(hi0, hi1), fmaxf(lo0, lo1));
  if (kPlus1) d = __fadd_rn(d, 1.0f);
  return fmaxf(d, 0.0f);
}

template <bool kPlus1>
__device__ __forceinline__ float intersection(const float4 a,
                                              const float4 b) {
  return __fmul_rn(side<kPlus1>(a.x, a.z, b.x, b.z),
                   side<kPlus1>(a.y, a.w, b.y, b.w));
}

__device__ __forceinline__ float union_of(float area_a, float area_b,
                                          float inter) {
  return __fsub_rn(__fadd_rn(area_a, area_b), inter);
}

// Whether the test decides the pair (implies union > 0).
__device__ __forceinline__ bool decides(float uni, const Split& s) {
  return uni >= s.umin && uni <= s.umax;
}

// Its verdict where it decides: fl(inter / union) > thr.
__device__ __forceinline__ bool exceeds(float inter, float uni,
                                        const Split& s) {
  return __fmaf_rn(-s.thr, uni, inter) > __fmul_rn(s.h, uni);
}

// The quotient's test, for a pair with union > 0 that it does not decide.
__device__ __forceinline__ bool exceeds_by_division(float inter, float uni,
                                                    float thr) {
  return __fdiv_rn(inter, uni) > thr;
}

}  // namespace iou_test
