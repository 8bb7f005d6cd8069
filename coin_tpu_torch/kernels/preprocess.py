"""Launchers of K10, the bilinear resize (K10a) and the fused normalise +
flip (K10b) (csrc/preprocess.cu).

Counterparts of ``coin_tpu/ops/preprocess.py:44`` ``resize_bilinear`` and
``:67`` ``normalize_flip``; the plain PyTorch versions and the public
functions are in ``coin_tpu_torch/ops/preprocess.py``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from coin_tpu_torch.kernels.build import check, library


def resize_taps(scale) -> int:
    """Tap window of one output row or column: every source index whose
    tent weight can be non-zero, with the f32 support of
    ``_resize_matrix``."""
    support = max(np.float32(1.0), np.float32(1.0) / np.float32(scale))
    return int(math.ceil(2.0 * float(support))) + 2


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry ``name`` of csrc/preprocess.cu (built at first use),
    with its argument types set once."""
    fn = getattr(library("preprocess"), name)
    fn.argtypes = {
        "coin_resize_bilinear": [ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 5,
        "coin_normalize_flip": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.POINTER(ctypes.c_float)] * 2 + [ctypes.c_void_p],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def resize_bilinear_cuda(image: torch.Tensor, scale,
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """image (H0, W0, 3) uint8 or float32 on a CUDA device → (H1, W1, 3)
    float32, as ``resize_bilinear_plain``."""
    from coin_tpu_torch.ops.preprocess import scaled_extent
    if not image.is_cuda:
        raise ValueError("resize_bilinear_cuda: image must be on a CUDA "
                         "device")
    if image.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"resize_bilinear_cuda: image {image.dtype} (uint8 "
                        "or float32)")
    if image.dim() != 3 or image.shape[-1] != 3:
        raise ValueError(f"resize_bilinear_cuda: shape {tuple(image.shape)}"
                         " (H, W, 3)")
    s = float(np.float32(float(scale)))
    if not s > 0.0:
        raise ValueError(f"resize_bilinear_cuda: scale {scale} (> 0)")
    h0, w0, _ = image.shape
    h1, w1 = (int(v) for v in out_hw)
    dev = image.device
    out = torch.empty((h1, w1, 3), dtype=torch.float32, device=dev)
    if h0 * w0 == 0 or h1 * w1 == 0:
        return out.zero_()
    ny = min(scaled_extent(h0, s), h1)
    nx = min(scaled_extent(w0, s), w1)
    taps = resize_taps(s)
    image = image.contiguous()
    start = torch.empty(h1 + w1, dtype=torch.int32, device=dev)
    weight = torch.empty((h1 + w1) * taps, dtype=torch.float32, device=dev)
    tmp = torch.empty((max(ny, 1), w0, 3), dtype=torch.float32, device=dev)
    err = _entry("coin_resize_bilinear")(
        image.data_ptr(), int(image.dtype == torch.uint8), h0, w0, h1, w1,
        s, ny, nx, taps, start.data_ptr(), weight.data_ptr(), tmp.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "resize_bilinear")
    resize_bilinear_cuda.launches += 1
    return out


resize_bilinear_cuda.launches = 0


def normalize_flip_cuda(images_u8: torch.Tensor, flip: torch.Tensor,
                        mean: Sequence[float], std: Sequence[float]
                        ) -> torch.Tensor:
    """images_u8 (B, H, W, 3) uint8 and flip (B,) bool on one CUDA device
    → float32 (B, H, W, 3), bit for bit the plain version's."""
    if not images_u8.is_cuda or flip.device != images_u8.device:
        raise ValueError("normalize_flip_cuda: images and flip must be on "
                         "one CUDA device")
    if images_u8.dtype != torch.uint8 or flip.dtype != torch.bool:
        raise TypeError(f"normalize_flip_cuda: images {images_u8.dtype}, "
                        f"flip {flip.dtype} (uint8, bool)")
    if images_u8.dim() != 4 or images_u8.shape[-1] != 3 \
            or flip.shape != images_u8.shape[:1]:
        raise ValueError(f"normalize_flip_cuda: shapes "
                         f"{tuple(images_u8.shape)}, {tuple(flip.shape)}")
    b, h, w, _ = images_u8.shape
    out = torch.empty(images_u8.shape, dtype=torch.float32,
                      device=images_u8.device)
    if out.numel() == 0:
        return out
    images_u8 = images_u8.contiguous()
    # a bool is one byte 0 or 1: the kernel reads it in place
    flags = flip.contiguous().view(torch.uint8)
    err = _entry("coin_normalize_flip")(
        images_u8.data_ptr(), flags.data_ptr(), out.data_ptr(), b, h, w,
        (ctypes.c_float * 3)(*mean), (ctypes.c_float * 3)(*std),
        torch.cuda.current_stream(images_u8.device).cuda_stream)
    check(err, "normalize_flip")
    normalize_flip_cuda.launches += 1
    return out


normalize_flip_cuda.launches = 0
