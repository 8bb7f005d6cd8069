"""Launchers of K1, the RoIAlign forward kernel (csrc/roi_align.cu), and
K1b, its backward (csrc/roi_align_bwd.cu).

Counterparts of the TPU-shaped op ``coin_tpu/ops/roi_align.py:54``
``roi_align`` and of the autodiff transpose of its einsums (``:85-94``);
the plain PyTorch versions, the autograd function and the public function
are in ``coin_tpu_torch/ops/roi_align.py``.
"""

from __future__ import annotations

import ctypes

import torch

from coin_tpu_torch.kernels.build import check, library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    fn = library("roi_align").coin_roi_align_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = library("roi_align_bwd").coin_roi_align_bwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def roi_align_cuda(features: torch.Tensor, rois: torch.Tensor,
                   spatial_scale: float, resolution: int,
                   sampling_ratio: int) -> torch.Tensor:
    """features (B, H, W, C) f32/bf16 NHWC on a CUDA device; rois
    (B, N, 4) f32 xyxy in image coordinates → (B, N, R, R, C)."""
    if not features.is_cuda or rois.device != features.device:
        raise ValueError("roi_align_cuda: features and rois must be on one "
                         "CUDA device")
    if features.dtype not in _DTYPES or rois.dtype != torch.float32:
        raise TypeError(f"roi_align_cuda: features {features.dtype} (f32 or "
                        f"bf16), rois {rois.dtype} (f32)")
    if (features.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4
            or rois.shape[0] != features.shape[0]):
        raise ValueError(f"roi_align_cuda: shapes {tuple(features.shape)}, "
                         f"{tuple(rois.shape)}")
    if resolution * sampling_ratio > 32:
        raise ValueError("roi_align_cuda: resolution * sampling_ratio > 32")
    features = features.contiguous()
    rois = rois.contiguous()
    b, h, w, c = features.shape
    n = rois.shape[1]
    out = torch.empty((b, n, resolution, resolution, c),
                      dtype=features.dtype, device=features.device)
    if b * n == 0:
        return out
    err = _fn()(features.data_ptr(), rois.data_ptr(), out.data_ptr(),
                h, w, c, b * n, n, float(spatial_scale), resolution,
                sampling_ratio, _DTYPES[features.dtype],
                torch.cuda.current_stream(features.device).cuda_stream)
    check(err, "roi_align")
    roi_align_cuda.launches += 1
    return out


roi_align_cuda.launches = 0


def roi_align_backward_cuda(grad: torch.Tensor, rois: torch.Tensor,
                            features_shape, features_dtype: torch.dtype,
                            spatial_scale: float, resolution: int,
                            sampling_ratio: int) -> torch.Tensor:
    """grad (B, N, R, R, C) f32/bf16 and rois (B, N, 4) f32 on a CUDA
    device → the features' gradient (B, H, W, C) in ``features_dtype``,
    accumulated in f32."""
    if not grad.is_cuda or rois.device != grad.device:
        raise ValueError("roi_align_backward_cuda: grad and rois must be on "
                         "one CUDA device")
    if grad.dtype not in _DTYPES or rois.dtype != torch.float32:
        raise TypeError(f"roi_align_backward_cuda: grad {grad.dtype} (f32 "
                        f"or bf16), rois {rois.dtype} (f32)")
    b, h, w, c = features_shape
    n = rois.shape[1]
    if (grad.shape != (b, n, resolution, resolution, c)
            or rois.shape != (b, n, 4)):
        raise ValueError(f"roi_align_backward_cuda: shapes "
                         f"{tuple(grad.shape)}, {tuple(rois.shape)} for "
                         f"features {tuple(features_shape)}")
    grad = grad.contiguous()
    rois = rois.contiguous()
    dfeat = torch.zeros((b, h, w, c), dtype=torch.float32,
                        device=grad.device)
    if b * n == 0:
        return dfeat.to(features_dtype)
    err = _bwd_fn()(grad.data_ptr(), rois.data_ptr(), dfeat.data_ptr(),
                    h, w, c, b * n, n, float(spatial_scale), resolution,
                    sampling_ratio, _DTYPES[grad.dtype],
                    torch.cuda.current_stream(grad.device).cuda_stream)
    check(err, "roi_align_bwd")
    roi_align_backward_cuda.launches += 1
    return dfeat.to(features_dtype)


roi_align_backward_cuda.launches = 0
