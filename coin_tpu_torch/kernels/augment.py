"""Launcher of K4, the strong and weak views kernel (csrc/augment.cu).

Counterpart of the TPU-shaped op ``coin_tpu/data/augment.py:106``
``preprocess_batch``; the plain PyTorch version, the draws and the public
function are in ``coin_tpu_torch/data/augment.py``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from coin_tpu_torch.kernels.build import check, library

PARTIALS = 128      # gray-mean partials per image (csrc/augment.cu)
_norms: Dict[Tuple[float, ...], Tuple[ctypes.Array, ctypes.Array]] = {}


def _fn():
    fn = library("augment").coin_augment
    if fn.argtypes is None:            # the first call into this library
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _norm(mean: Sequence[float], std: Sequence[float]):
    """The ctypes arrays of one (mean, std) pair, made once."""
    key = (*mean, *std)
    arrays = _norms.get(key)
    if arrays is None:
        arrays = _norms[key] = ((ctypes.c_float * 3)(*mean),
                                (ctypes.c_float * 3)(*std))
    return arrays


def augment_cuda(images_u8: torch.Tensor, params: torch.Tensor,
                 mean: Sequence[float], std: Sequence[float],
                 weak: bool = True):
    """images_u8 (B, H, W, 3) uint8 and params (B, 20) float32 (the layout
    of ``data.augment.augment_params``) on one CUDA device → (strong,
    weak), each float32 (B, H, W, 3); weak is None, neither allocated nor
    written, when ``weak`` is false. Both views and the kernel's gray-mean
    partials share one allocation."""
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
    n = images_u8.numel()
    views = 2 * n if weak else n
    partials_at = (views + 3) // 4 * 4        # floats, 16-byte aligned
    buf = torch.empty(partials_at + 2 * PARTIALS * b, dtype=torch.float32,
                      device=images_u8.device)
    strong = buf[:n].view(images_u8.shape)
    weak_view = buf[n:2 * n].view(images_u8.shape) if weak else None
    if n == 0:
        return strong, weak_view
    mean_c, std_c = _norm(mean, std)
    err = _fn()(images_u8.data_ptr(), params.data_ptr(),
                buf.data_ptr() + 4 * partials_at, strong.data_ptr(),
                weak_view.data_ptr() if weak else None, b, h, w, mean_c,
                std_c, torch.cuda.current_stream(images_u8.device).cuda_stream)
    check(err, "augment")
    augment_cuda.launches += 1
    return strong, weak_view


augment_cuda.launches = 0
