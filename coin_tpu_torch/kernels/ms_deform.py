"""Launcher of K7, multi-scale deformable sampling (csrc/ms_deform.cu).

Counterpart of ``coin_tpu/models/deformable.py:20`` ``ms_deform_sample``;
the plain PyTorch version and ``MSDeformAttention`` are in
``coin_tpu_torch/models/deformable.py``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from coin_tpu_torch.kernels.build import check, library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    fn = library("ms_deform").coin_ms_deform
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ms_deform_cuda(values: torch.Tensor, shapes: torch.Tensor,
                   starts: torch.Tensor, locations: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """values (B, ΣHW, H, D) f32/bf16 on a CUDA device, D a multiple of 8;
    shapes (L, 2) int32 (h, w) and starts (L,) int32 on the same device;
    locations (B, Q, H, L, P, 2) f32; weights (B, Q, H, L, P) f32 →
    (B, Q, H, D) in the values' dtype."""
    dev = values.device
    if not values.is_cuda or any(t.device != dev for t in
                                 (shapes, starts, locations, weights)):
        raise ValueError("ms_deform_cuda: every tensor must be on one CUDA "
                         "device")
    if (values.dtype not in _DTYPES or locations.dtype != torch.float32
            or weights.dtype != torch.float32
            or shapes.dtype != torch.int32 or starts.dtype != torch.int32):
        raise TypeError(f"ms_deform_cuda: values {values.dtype} (f32 or "
                        f"bf16), locations {locations.dtype} and weights "
                        f"{weights.dtype} (f32), shapes {shapes.dtype} and "
                        f"starts {starts.dtype} (int32)")
    if values.dim() != 4 or locations.dim() != 6:
        raise ValueError(f"ms_deform_cuda: values {tuple(values.shape)}, "
                         f"locations {tuple(locations.shape)}")
    b, s, h, d = values.shape
    _, q, _, lv, p, _ = locations.shape
    if (tuple(locations.shape) != (b, q, h, lv, p, 2)
            or tuple(weights.shape) != (b, q, h, lv, p)
            or tuple(shapes.shape) != (lv, 2) or tuple(starts.shape) != (lv,)
            or d % 8):
        raise ValueError(f"ms_deform_cuda: values {tuple(values.shape)}, "
                         f"locations {tuple(locations.shape)}, weights "
                         f"{tuple(weights.shape)}, shapes "
                         f"{tuple(shapes.shape)}, starts {tuple(starts.shape)}"
                         " (D a multiple of 8)")
    values = values.contiguous()
    locations, weights = locations.contiguous(), weights.contiguous()
    shapes, starts = shapes.contiguous(), starts.contiguous()
    if values.data_ptr() % 16:
        raise ValueError("ms_deform_cuda: values not 16-byte aligned")
    if locations.data_ptr() % 8:          # read as float2
        locations = locations.clone()
    out = torch.empty((b, q, h, d), dtype=values.dtype, device=dev)
    if b * q == 0:
        return out
    err = _fn()(values.data_ptr(), locations.data_ptr(), weights.data_ptr(),
                shapes.data_ptr(), starts.data_ptr(), out.data_ptr(), b, s, q,
                h, lv, p, d, _DTYPES[values.dtype],
                torch.cuda.current_stream(dev).cuda_stream)
    check(err, "ms_deform")
    ms_deform_cuda.launches += 1
    return out


ms_deform_cuda.launches = 0
