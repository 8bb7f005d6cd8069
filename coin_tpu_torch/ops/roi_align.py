"""RoIAlign, aligned=True with a static sampling ratio, and its gradient
(counterpart of coin_tpu/ops/roi_align.py:28-104).

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
