"""Launcher of K4n, the u8 → CLIP-normalised f32 kernel
(csrc/normalize.cu).

Counterpart of ``coin_tpu/data/augment.py:122`` ``normalize_batch``; the
plain PyTorch version and the public function are in
``coin_tpu_torch/data/augment.py``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from coin_tpu_torch.kernels.build import check, library


def _fn():
    fn = library("normalize").coin_normalize
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.POINTER(ctypes.c_float),
                   ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def normalize_cuda(images_u8: torch.Tensor, mean: Sequence[float],
                   std: Sequence[float]) -> torch.Tensor:
    """images_u8 (..., 3) uint8 on a CUDA device → float32, same shape."""
    if not images_u8.is_cuda:
        raise ValueError("normalize_cuda: images must be on a CUDA device")
    if images_u8.dtype != torch.uint8:
        raise TypeError(f"normalize_cuda: images {images_u8.dtype} (uint8)")
    if images_u8.dim() < 1 or images_u8.shape[-1] != 3:
        raise ValueError(f"normalize_cuda: shape {tuple(images_u8.shape)} "
                         "(channels last, 3 channels)")
    images_u8 = images_u8.contiguous()
    out = torch.empty(images_u8.shape, dtype=torch.float32,
                      device=images_u8.device)
    n = images_u8.numel()
    if n == 0:
        return out
    if images_u8.data_ptr() % 16:
        raise ValueError("normalize_cuda: input not 16-byte aligned")
    m = (ctypes.c_float * 3)(*mean)
    s = (ctypes.c_float * 3)(*std)
    err = _fn()(images_u8.data_ptr(), out.data_ptr(), n, m, s,
                torch.cuda.current_stream(images_u8.device).cuda_stream)
    check(err, "normalize")
    normalize_cuda.launches += 1
    return out


normalize_cuda.launches = 0
