"""Launcher of K3, the greedy NMS kernels (csrc/nms.cu): the suppression
mask, then the sweep.

Counterpart of ``coin_tpu/ops/nms.py:75`` ``_nms_sorted``; the plain
PyTorch version, the public ``nms_keep_mask`` and the IoU test's
threshold split (``threshold_split``, with ``iou_exceeds``, the kernel's
division-free test in PyTorch) are in ``coin_tpu_torch/ops/nms.py``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from coin_tpu_torch.kernels.build import check, library
from coin_tpu_torch.ops.nms import threshold_split

TILE = 64


def _fn():
    fn = library("nms").coin_nms
    if fn.argtypes is None:            # the first call into this library
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def nms_sorted_cuda(sboxes: torch.Tensor, counts: torch.Tensor,
                    iou_threshold: float, plus1: bool,
                    mid_event: Optional[torch.cuda.Event] = None
                    ) -> torch.Tensor:
    """sboxes (B, N, 4) f32, sorted by descending score with the valid rows
    first; counts (B,) int32 valid rows per image → keep (B, N) bool.
    ``mid_event``, an event already recorded once, is recorded again
    between the mask and the sweep, to time the two apart."""
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
    # the kernel writes each row's keep flag as a byte, 0 or 1
    keep = torch.empty((b, n), dtype=torch.bool, device=sboxes.device)
    if b * n == 0:
        return keep
    sboxes = sboxes.contiguous()
    if sboxes.data_ptr() % 16:
        sboxes = sboxes.clone()       # the kernel reads a box as a float4
    counts = counts.contiguous()
    col_tiles = -(-n // TILE)
    if col_tiles * 8 > 40 * 1024:
        raise ValueError(f"nms_sorted_cuda: N={n} exceeds the sweep's "
                         "shared-memory bitset")
    # the suppression words, tile by tile: (row tile, column tile, row)
    mask = torch.empty((b, col_tiles, col_tiles, TILE), dtype=torch.int64,
                       device=sboxes.device)
    thr, h, umin, fast = threshold_split(iou_threshold)
    err = _fn()(sboxes.data_ptr(), counts.data_ptr(), mask.data_ptr(),
                keep.data_ptr(), b, n, thr, h, umin, int(fast), int(plus1),
                None if mid_event is None else mid_event.cuda_event,
                torch.cuda.current_stream(sboxes.device).cuda_stream)
    check(err, "nms")
    nms_sorted_cuda.launches += 1
    return keep


nms_sorted_cuda.launches = 0
