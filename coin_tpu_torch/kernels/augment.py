"""Launcher of K4, the strong and weak views kernel (csrc/augment.cu).

Counterpart of the TPU-shaped op ``coin_tpu/data/augment.py:106``
``preprocess_batch``; the plain PyTorch version, the draws and the public
function are in ``coin_tpu_torch/data/augment.py``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from coin_tpu_torch.kernels.build import check, library


def _fn():
    fn = library("augment").coin_augment
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def augment_cuda(images_u8: torch.Tensor, params: torch.Tensor,
                 mean: Sequence[float], std: Sequence[float]):
    """images_u8 (B, H, W, 3) uint8 and params (B, 20) float32 (the layout
    of ``data.augment.augment_params``) on one CUDA device → (strong,
    weak), each float32 (B, H, W, 3)."""
    if not images_u8.is_cuda or params.device != images_u8.device:
        raise ValueError("augment_cuda: images and params must be on one "
                         "CUDA device")
    if images_u8.dtype != torch.uint8 or params.dtype != torch.float32:
        raise TypeError(f"augment_cuda: images {images_u8.dtype} (uint8), "
                        f"params {params.dtype} (float32)")
    if images_u8.dim() != 4 or images_u8.shape[-1] != 3 \
            or tuple(params.shape) != (images_u8.shape[0], 20):
        raise ValueError(f"augment_cuda: shapes {tuple(images_u8.shape)}, "
                         f"{tuple(params.shape)}")
    images_u8 = images_u8.contiguous()
    params = params.contiguous()
    b, h, w, _ = images_u8.shape
    dev = images_u8.device
    strong = torch.empty(images_u8.shape, dtype=torch.float32, device=dev)
    weak = torch.empty_like(strong)
    if images_u8.numel() == 0:
        return strong, weak
    sums = torch.zeros(b, dtype=torch.float64, device=dev)
    scratch = torch.empty_like(strong)
    err = _fn()(images_u8.data_ptr(), params.data_ptr(), sums.data_ptr(),
                scratch.data_ptr(), strong.data_ptr(), weak.data_ptr(),
                b, h, w, (ctypes.c_float * 3)(*mean),
                (ctypes.c_float * 3)(*std),
                torch.cuda.current_stream(dev).cuda_stream)
    check(err, "augment")
    augment_cuda.launches += 1
    return strong, weak


augment_cuda.launches = 0
