"""Launchers of K1, the RoIAlign forward kernel (csrc/roi_align.cu), K1b,
its backward (csrc/roi_align_bwd.cu), K5, the int8 RoIAlign
(csrc/roi_align_int8.cu), and K5b, its backward (csrc/roi_align_int8_bwd.cu).

Counterparts of the TPU-shaped ops ``coin_tpu/ops/roi_align.py:54``
``roi_align``, the autodiff transpose of its einsums (``:85-94``),
``roi_align_int8`` (``:188``) and its custom VJP's backward ``_ra_int8_bwd``
(``:213``); the plain PyTorch versions, the autograd functions and the
public functions are in ``coin_tpu_torch/ops/roi_align.py``.
"""

from __future__ import annotations

import ctypes

import torch

from coin_tpu_torch.kernels.build import check, library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    fn = library("roi_align").coin_roi_align_fwd
    if fn.argtypes is None:            # the first call into this library
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = library("roi_align_bwd").coin_roi_align_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _int8_fn():
    fn = library("roi_align_int8").coin_roi_align_int8_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _int8_bwd_fn():
    fn = library("roi_align_int8_bwd").coin_roi_align_int8_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
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
    if not 1 <= sampling_ratio <= 4 or resolution * sampling_ratio > 32:
        raise ValueError(f"roi_align_cuda: sampling ratio {sampling_ratio} "
                         f"outside 1-4 or resolution * sampling ratio > 32")
    features = features.contiguous()
    rois = rois.contiguous()
    b, h, w, c = features.shape
    n = rois.shape[1]
    if h * w * c >= 2 ** 31:
        raise ValueError(f"roi_align_cuda: a {h} x {w} x {c} map exceeds "
                         "the kernel's 32-bit offsets")
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


def _check_rois(what, t, rois, resolution, sampling_ratio):
    if not t.is_cuda or rois.device != t.device:
        raise ValueError(f"{what}: tensors must be on one CUDA device")
    if t.dtype not in _DTYPES or rois.dtype != torch.float32:
        raise TypeError(f"{what}: {t.dtype} (f32 or bf16), rois "
                        f"{rois.dtype} (f32)")
    if resolution > 32 or not 1 <= sampling_ratio <= 4:
        raise ValueError(f"{what}: resolution {resolution} > 32 or "
                         f"sampling ratio {sampling_ratio} outside 1-4")


def roi_align_int8_cuda(features: torch.Tensor, rois: torch.Tensor,
                        spatial_scale: float, resolution: int,
                        sampling_ratio: int) -> torch.Tensor:
    """K5: features (B, H, W, C) f32/bf16 NHWC on a CUDA device, rois
    (B, N, 4) f32 → (B, N, R, R, C) in the features' dtype, equal bit for
    bit to ``roi_align_int8_plain``."""
    _check_rois("roi_align_int8_cuda", features, rois, resolution,
                sampling_ratio)
    if (features.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4
            or rois.shape[0] != features.shape[0]):
        raise ValueError(f"roi_align_int8_cuda: shapes "
                         f"{tuple(features.shape)}, {tuple(rois.shape)}")
    features = features.contiguous()
    rois = rois.contiguous()
    b, h, w, c = features.shape
    n = rois.shape[1]
    dev = features.device
    out = torch.empty((b, n, resolution, resolution, c),
                      dtype=features.dtype, device=dev)
    if b * n == 0:
        return out
    amax = torch.zeros((b, c), dtype=torch.int32, device=dev)
    q = torch.empty((b, h, w, c), dtype=torch.int8, device=dev)
    sf = torch.empty((b, c), dtype=torch.float32, device=dev)
    err = _int8_fn()(features.data_ptr(), rois.data_ptr(), out.data_ptr(),
                     amax.data_ptr(), q.data_ptr(), sf.data_ptr(), b, h, w,
                     c, b * n, n, float(spatial_scale), resolution,
                     sampling_ratio, _DTYPES[features.dtype],
                     torch.cuda.current_stream(dev).cuda_stream)
    check(err, "roi_align_int8")
    roi_align_int8_cuda.launches += 1
    return out


roi_align_int8_cuda.launches = 0


def roi_align_int8_backward_cuda(grad: torch.Tensor, rois: torch.Tensor,
                                 features_shape, features_dtype: torch.dtype,
                                 spatial_scale: float, resolution: int,
                                 sampling_ratio: int) -> torch.Tensor:
    """K5b: grad (B, N, R, R, C) and rois (B, N, 4) f32 on a CUDA device →
    the features' gradient (B, H, W, C) in ``features_dtype`` (the gradient
    is first cast to it, as ``_ra_int8_bwd`` does), accumulated in f32."""
    if features_dtype not in _DTYPES:
        raise TypeError(f"roi_align_int8_backward_cuda: features "
                        f"{features_dtype} (f32 or bf16)")
    grad = grad.to(features_dtype)
    _check_rois("roi_align_int8_backward_cuda", grad, rois, resolution,
                sampling_ratio)
    b, h, w, c = features_shape
    n = rois.shape[1]
    if (grad.shape != (b, n, resolution, resolution, c)
            or rois.shape != (b, n, 4)):
        raise ValueError(f"roi_align_int8_backward_cuda: shapes "
                         f"{tuple(grad.shape)}, {tuple(rois.shape)} for "
                         f"features {tuple(features_shape)}")
    grad = grad.contiguous()
    rois = rois.contiguous()
    dfeat = torch.zeros((b, h, w, c), dtype=torch.float32,
                        device=grad.device)
    if b * n == 0:
        return dfeat.to(features_dtype)
    err = _int8_bwd_fn()(grad.data_ptr(), rois.data_ptr(), dfeat.data_ptr(),
                         h, w, c, b * n, n, float(spatial_scale), resolution,
                         sampling_ratio, _DTYPES[features_dtype],
                         torch.cuda.current_stream(grad.device).cuda_stream)
    check(err, "roi_align_int8_bwd")
    roi_align_int8_backward_cuda.launches += 1
    return dfeat.to(features_dtype)


roi_align_int8_backward_cuda.launches = 0
