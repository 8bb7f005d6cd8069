"""RoIAlign, aligned=True with a static sampling ratio, and its gradient
(counterpart of coin_tpu/ops/roi_align.py:28-104), and the int8 RoIAlign
of ``TPU.INT8_ROI`` (counterpart of :107-234).

The forward runs kernel K1 (csrc/roi_align.cu) on a CUDA tensor and
:func:`roi_align_plain` on a CPU tensor; the plain version keeps the JAX
package's separable interpolation-matrix form in f32. The backward, the
features' gradient, runs kernel K1b (csrc/roi_align_bwd.cu) on a CUDA
tensor and :func:`roi_align_backward_plain`, the explicit transpose of the
plain version's two einsums, on a CPU tensor; the RoIs get no gradient
(the JAX package computes them under stop_gradient). Both kernels are
launched by kernels/roi_align.py.

Semantics: rois * spatial_scale - 0.5; sample k of cell r at
start + (r + (k + 0.5) / s) * bin; samples outside [-1, size] are 0, the
rest are clamped to [0, size - 1]; each cell is the mean of its s x s
samples. The JAX bf16 path rounds its (N, R, short, C) intermediate to
bf16; the kernel and the plain version round once, at the output.

The int8 RoIAlign runs kernel K5 (csrc/roi_align_int8.cu) on a CUDA tensor
and :func:`roi_align_int8_plain` on a CPU tensor. It quantises the features
per channel to s8 (scale max|f| / 127 over the map) and the interpolation
matrices to s8 at a static 1/127 step, contracts the longer spatial axis
first (W when w >= h) with s32 sums, requantises that intermediate as
round(/127) clipped to +-127, contracts the other axis with s32 sums and
rescales by s_f / 127 in f32, then casts to the features' dtype. Every sum
is an exact integer, so the kernel and the plain version agree bit for
bit, and both agree with the JAX source run op by op (compiled JAX
multiplies by 1/127 where the source divides). Its backward is the
straight-through bilinear transpose of ``_ra_int8_bwd`` (:213-232): the
interpolation matrices and the gradient in the features' dtype, the
(N, H, S, C) intermediate rounded to that dtype, f32 sums; kernel K5b
(csrc/roi_align_int8_bwd.cu) on a CUDA tensor,
:func:`roi_align_int8_backward_plain` on a CPU tensor. The RoIs get a zero
gradient.
"""

from __future__ import annotations

import torch

# rois per step of the plain version: bounds its (rois, H, R, C) f32
# intermediate to about 0.5 GB at the shipped shapes
_CHUNK = 256


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d correctly rounded on every device: PyTorch's CUDA kernels
    multiply by the reciprocal of a scalar divisor, which moves a sample
    coordinate by an ulp against the JAX op and the kernel."""
    return a / torch.full_like(a, d)


def _interp_matrix(start: torch.Tensor, bin_size: torch.Tensor,
                   resolution: int, sampling: int, size: int) -> torch.Tensor:
    """(N, R, size) per-roi interpolation weights along one axis, with the
    s samples of each output cell averaged."""
    n = start.shape[0]
    r = torch.arange(resolution * sampling, dtype=start.dtype,
                     device=start.device)
    cell = torch.div(r, sampling, rounding_mode="floor")
    k = r - cell * sampling
    pos = start[:, None] + (cell[None] + _div(k[None] + 0.5, sampling)) \
        * bin_size[:, None]
    in_range = (pos >= -1.0) & (pos <= size)
    pos_c = pos.clamp(0.0, size - 1)
    grid = torch.arange(size, dtype=start.dtype, device=start.device)
    tent = (1.0 - (pos_c[:, :, None] - grid).abs()).clamp_min(0.0)
    tent = tent * in_range[:, :, None]
    return tent.reshape(n, resolution, sampling, size).mean(dim=2)


def roi_align_plain(features: torch.Tensor, rois: torch.Tensor,
                    spatial_scale: float, resolution: int = 14,
                    sampling_ratio: int = 2) -> torch.Tensor:
    """Plain version of K1: features (B, H, W, C), rois (B, N, 4) →
    (B, N, R, R, C) in the features' dtype, computed in f32."""
    b, h, w, c = features.shape
    out = torch.empty((b, rois.shape[1], resolution, resolution, c),
                      dtype=features.dtype, device=features.device)
    for i in range(b):
        f = features[i].float()
        for s in range(0, rois.shape[1], _CHUNK):
            r = rois[i, s:s + _CHUNK].float() * spatial_scale - 0.5
            x1, y1, x2, y2 = r.unbind(-1)
            ax = _interp_matrix(x1, _div(x2 - x1, resolution), resolution,
                                sampling_ratio, w)
            ay = _interp_matrix(y1, _div(y2 - y1, resolution), resolution,
                                sampling_ratio, h)
            if w >= h:
                tmp = torch.einsum("nsw,hwc->nhsc", ax, f)
                o = torch.einsum("nrh,nhsc->nrsc", ay, tmp)
            else:
                tmp = torch.einsum("nrh,hwc->nrwc", ay, f)
                o = torch.einsum("nrwc,nsw->nrsc", tmp, ax)
            out[i, s:s + _CHUNK] = o.to(features.dtype)
    return out


def roi_align_backward_plain(grad: torch.Tensor, rois: torch.Tensor,
                             features_shape, features_dtype: torch.dtype,
                             spatial_scale: float, resolution: int = 14,
                             sampling_ratio: int = 2) -> torch.Tensor:
    """Plain version of K1b: grad (B, N, R, R, C), rois (B, N, 4) → the
    gradient of the features (B, H, W, C) in ``features_dtype``, computed
    in f32 as Σ ay·ax·grad."""
    b, h, w, c = features_shape
    out = torch.zeros((b, h, w, c), dtype=torch.float32, device=grad.device)
    for i in range(b):
        for s in range(0, rois.shape[1], _CHUNK):
            r = rois[i, s:s + _CHUNK].float() * spatial_scale - 0.5
            x1, y1, x2, y2 = r.unbind(-1)
            ax = _interp_matrix(x1, _div(x2 - x1, resolution), resolution,
                                sampling_ratio, w)
            ay = _interp_matrix(y1, _div(y2 - y1, resolution), resolution,
                                sampling_ratio, h)
            g = grad[i, s:s + _CHUNK].float()
            tmp = torch.einsum("nrh,nrsc->nhsc", ay, g)
            out[i] += torch.einsum("nsw,nhsc->hwc", ax, tmp)
    return out.to(features_dtype)


def _forward(features, rois, spatial_scale, resolution, sampling_ratio):
    if features.is_cuda:
        from coin_tpu_torch.kernels.roi_align import roi_align_cuda
        return roi_align_cuda(features, rois, spatial_scale, resolution,
                              sampling_ratio)
    return roi_align_plain(features, rois, spatial_scale, resolution,
                           sampling_ratio)


def roi_align_backward(grad: torch.Tensor, rois: torch.Tensor,
                       features_shape, features_dtype: torch.dtype,
                       spatial_scale: float, resolution: int = 14,
                       sampling_ratio: int = 2) -> torch.Tensor:
    """The features' gradient: K1b on a CUDA tensor, the plain version on
    a CPU tensor."""
    if grad.is_cuda:
        from coin_tpu_torch.kernels.roi_align import roi_align_backward_cuda
        return roi_align_backward_cuda(grad, rois, features_shape,
                                       features_dtype, spatial_scale,
                                       resolution, sampling_ratio)
    return roi_align_backward_plain(grad, rois, features_shape,
                                    features_dtype, spatial_scale,
                                    resolution, sampling_ratio)


class RoIAlign(torch.autograd.Function):
    """RoIAlign with the features' gradient; the RoIs are constants."""

    @staticmethod
    def forward(ctx, features, rois, spatial_scale, resolution,
                sampling_ratio):
        ctx.save_for_backward(rois)
        ctx.meta = (tuple(features.shape), features.dtype, spatial_scale,
                    resolution, sampling_ratio)
        return _forward(features, rois, spatial_scale, resolution,
                        sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        rois, = ctx.saved_tensors
        shape, dtype, scale, res, sampling = ctx.meta
        return (roi_align_backward(grad, rois, shape, dtype, scale, res,
                                   sampling), None, None, None, None)


def roi_align_batched(features: torch.Tensor, rois: torch.Tensor,
                      spatial_scale: float, resolution: int = 14,
                      sampling_ratio: int = 2) -> torch.Tensor:
    """features (B, H, W, C) NHWC, rois (B, N, 4) xyxy image coordinates
    → (B, N, R, R, C), differentiable in the features."""
    return RoIAlign.apply(features, rois.detach().float(), spatial_scale,
                          resolution, sampling_ratio)


def roi_align(features: torch.Tensor, rois: torch.Tensor,
              spatial_scale: float, resolution: int = 14,
              sampling_ratio: int = 2) -> torch.Tensor:
    """One image: features (H, W, C), rois (N, 4) → (N, R, R, C)."""
    return roi_align_batched(features[None], rois[None], spatial_scale,
                             resolution, sampling_ratio)[0]


# ------------------------------------------------------------ int8 (K5)
def _interp_pair(rois: torch.Tensor, spatial_scale: float, resolution: int,
                 sampling_ratio: int, h: int, w: int):
    """(ax (N, R, W), ay (N, R, H)) of rois (N, 4), in f32."""
    r = rois.float() * spatial_scale - 0.5
    x1, y1, x2, y2 = r.unbind(-1)
    ax = _interp_matrix(x1, _div(x2 - x1, resolution), resolution,
                        sampling_ratio, w)
    ay = _interp_matrix(y1, _div(y2 - y1, resolution), resolution,
                        sampling_ratio, h)
    return ax, ay


def quant_feat_plain(features: torch.Tensor):
    """One map (H, W, C) → (s8 values as f32 (H, W, C), scale s_f (C,)):
    s_f = max(max|f|, 1e-12) / 127 per channel, q = clip(round(f / s_f)),
    a NaN (which JAX's cast to s8 makes 0) as 0; a NaN keeps its channel's
    scale NaN."""
    f32 = features.float()
    s_f = _div(f32.abs().amax(dim=(0, 1)).clamp_min(1e-12), 127.0)
    return (f32 / s_f).round().clamp(-127, 127).nan_to_num(0.0), s_f


def _requant(tmp: torch.Tensor) -> torch.Tensor:
    """An s32 sum (held exactly in f64) back onto the s8 grid:
    clip(round(f32(tmp) / 127), -127, 127)."""
    return _div(tmp.float(), 127.0).round().clamp(-127, 127).double()


def roi_align_int8_plain(features: torch.Tensor, rois: torch.Tensor,
                         spatial_scale: float, resolution: int = 14,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """Plain version of K5: features (B, H, W, C), rois (B, N, 4) →
    (B, N, R, R, C) in the features' dtype. The s8 values and their
    integer sums are held in f64, where every partial sum is exact."""
    b, h, w, c = features.shape
    out = torch.empty((b, rois.shape[1], resolution, resolution, c),
                      dtype=features.dtype, device=features.device)
    for i in range(b):
        fq, s_f = quant_feat_plain(features[i])
        fq = fq.double()
        scale = _div(s_f, 127.0)
        for s in range(0, rois.shape[1], _CHUNK):
            ax, ay = _interp_pair(rois[i, s:s + _CHUNK], spatial_scale,
                                  resolution, sampling_ratio, h, w)
            axq = (ax * 127.0).round().double()
            ayq = (ay * 127.0).round().double()
            if w >= h:
                tmp = _requant(torch.einsum("nsw,hwc->nhsc", axq, fq))
                o = torch.einsum("nrh,nhsc->nrsc", ayq, tmp)
            else:
                tmp = _requant(torch.einsum("nrh,hwc->nrwc", ayq, fq))
                o = torch.einsum("nrwc,nsw->nrsc", tmp, axq)
            out[i, s:s + _CHUNK] = (o.float() * scale).to(features.dtype)
    return out


def roi_align_int8_backward_plain(grad: torch.Tensor, rois: torch.Tensor,
                                  features_shape,
                                  features_dtype: torch.dtype,
                                  spatial_scale: float, resolution: int = 14,
                                  sampling_ratio: int = 2) -> torch.Tensor:
    """Plain version of K5b, ``_ra_int8_bwd``'s transpose: grad
    (B, N, R, R, C), rois (B, N, 4) → the features' gradient (B, H, W, C)
    in ``features_dtype``: ax, ay and the gradient in that dtype,
    t = Σ_r ay·g rounded to it, Σ_{n,s} t·ax in f32."""
    b, h, w, c = features_shape
    out = torch.zeros((b, h, w, c), dtype=torch.float32, device=grad.device)
    for i in range(b):
        for s in range(0, rois.shape[1], _CHUNK):
            ax, ay = _interp_pair(rois[i, s:s + _CHUNK], spatial_scale,
                                  resolution, sampling_ratio, h, w)
            ax = ax.to(features_dtype).float()
            ay = ay.to(features_dtype).float()
            g = grad[i, s:s + _CHUNK].to(features_dtype).float()
            t = torch.einsum("nrh,nrsc->nhsc", ay, g)
            t = t.to(features_dtype).float()
            out[i] += torch.einsum("nhsc,nsw->hwc", t, ax)
    return out.to(features_dtype)


def _int8_forward(features, rois, spatial_scale, resolution, sampling_ratio):
    if features.is_cuda:
        from coin_tpu_torch.kernels.roi_align import roi_align_int8_cuda
        return roi_align_int8_cuda(features, rois, spatial_scale, resolution,
                                   sampling_ratio)
    return roi_align_int8_plain(features, rois, spatial_scale, resolution,
                                sampling_ratio)


def roi_align_int8_backward(grad: torch.Tensor, rois: torch.Tensor,
                            features_shape, features_dtype: torch.dtype,
                            spatial_scale: float, resolution: int = 14,
                            sampling_ratio: int = 2) -> torch.Tensor:
    """The features' gradient of the int8 RoIAlign: K5b on a CUDA tensor,
    the plain version on a CPU tensor."""
    if grad.is_cuda:
        from coin_tpu_torch.kernels.roi_align import (
            roi_align_int8_backward_cuda)
        return roi_align_int8_backward_cuda(grad, rois, features_shape,
                                            features_dtype, spatial_scale,
                                            resolution, sampling_ratio)
    return roi_align_int8_backward_plain(grad, rois, features_shape,
                                         features_dtype, spatial_scale,
                                         resolution, sampling_ratio)


class RoIAlignInt8(torch.autograd.Function):
    """The int8 RoIAlign with its straight-through gradient; the RoIs get
    none (JAX's zero cotangent: they are constants of the step)."""

    @staticmethod
    def forward(ctx, features, rois, spatial_scale, resolution,
                sampling_ratio):
        ctx.save_for_backward(rois)
        ctx.meta = (tuple(features.shape), features.dtype, spatial_scale,
                    resolution, sampling_ratio)
        return _int8_forward(features, rois, spatial_scale, resolution,
                             sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        rois, = ctx.saved_tensors
        shape, dtype, scale, res, sampling = ctx.meta
        return (roi_align_int8_backward(grad, rois, shape, dtype, scale, res,
                                        sampling), None, None, None, None)


def roi_align_int8_batched(features: torch.Tensor, rois: torch.Tensor,
                           spatial_scale: float, resolution: int = 14,
                           sampling_ratio: int = 2) -> torch.Tensor:
    """The int8 RoIAlign: features (B, H, W, C) NHWC, rois (B, N, 4) →
    (B, N, R, R, C), differentiable in the features."""
    return RoIAlignInt8.apply(features, rois.detach().float(),
                              spatial_scale, resolution, sampling_ratio)
