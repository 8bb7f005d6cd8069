"""Launcher of K3, the greedy NMS kernels (csrc/nms.cu).

Counterpart of ``coin_tpu/ops/nms.py:75`` ``_nms_sorted``; the plain
PyTorch version and the public ``nms_keep_mask`` are in
``coin_tpu_torch/ops/nms.py``.
"""

from __future__ import annotations

import ctypes

import torch

from coin_tpu_torch.kernels.build import check, library

TILE = 64


def _fn():
    fn = library("nms").coin_nms
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nms_sorted_cuda(sboxes: torch.Tensor, counts: torch.Tensor,
                    iou_threshold: float, plus1: bool) -> torch.Tensor:
    """sboxes (B, N, 4) f32, sorted by descending score with the valid rows
    first; counts (B,) int32 valid rows per image → keep (B, N) bool."""
    if not sboxes.is_cuda or counts.device != sboxes.device:
        raise ValueError("nms_sorted_cuda: boxes and counts must be on one "
                         "CUDA device")
    if sboxes.dtype != torch.float32 or counts.dtype != torch.int32:
        raise TypeError(f"nms_sorted_cuda: boxes {sboxes.dtype} (f32), "
                        f"counts {counts.dtype} (int32)")
    if sboxes.dim() != 3 or sboxes.shape[-1] != 4 \
            or counts.shape != sboxes.shape[:1]:
        raise ValueError(f"nms_sorted_cuda: shapes {tuple(sboxes.shape)}, "
                         f"{tuple(counts.shape)}")
    b, n, _ = sboxes.shape
    keep = torch.empty((b, n), dtype=torch.uint8, device=sboxes.device)
    if b * n == 0:
        return keep.bool()
    sboxes = sboxes.contiguous()
    counts = counts.contiguous()
    col_tiles = -(-n // TILE)
    if col_tiles * 8 > 40 * 1024:
        raise ValueError(f"nms_sorted_cuda: N={n} exceeds the sweep's "
                         "shared-memory bitset")
    mask = torch.empty((b, n, col_tiles), dtype=torch.int64,
                       device=sboxes.device)
    err = _fn()(sboxes.data_ptr(), counts.data_ptr(), mask.data_ptr(),
                keep.data_ptr(), b, n, float(iou_threshold), int(plus1),
                torch.cuda.current_stream(sboxes.device).cuda_stream)
    check(err, "nms")
    nms_sorted_cuda.launches += 1
    return keep.bool()


nms_sorted_cuda.launches = 0
