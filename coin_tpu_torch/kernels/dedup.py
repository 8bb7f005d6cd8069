"""Launcher of K11, the IoU self-clustering kernel (csrc/dedup.cu).

Counterpart of the TPU-shaped op ``coin_tpu/ops/dedup.py:38``
``self_cluster_index`` (and ``self_cluster_mask``, ``:55``); the plain
PyTorch version and the public functions are in
``coin_tpu_torch/ops/dedup.py``. The IoU test's constants come from
``ops/nms.threshold_split_at_least``.
"""

from __future__ import annotations

import ctypes

import torch

from coin_tpu_torch.kernels.build import check, library
from coin_tpu_torch.ops.nms import threshold_split_at_least

MAX_N = 1024


def _fn():
    fn = library("dedup").coin_self_cluster
    if fn.argtypes is None:            # the first call into this library
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def self_cluster_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                      iou_threshold: float):
    """boxes (B, n, 4) f32 and valid (B, n) bool on a CUDA device →
    (keep (B, n) bool, rep (B, n) int64), equal to the plain version's."""
    if not boxes.is_cuda or valid.device != boxes.device:
        raise ValueError("self_cluster_cuda: boxes and valid must be on one "
                         "CUDA device")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"self_cluster_cuda: boxes {boxes.dtype} (f32), "
                        f"valid {valid.dtype} (bool)")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or valid.shape != boxes.shape[:2]:
        raise ValueError(f"self_cluster_cuda: shapes {tuple(boxes.shape)}, "
                         f"{tuple(valid.shape)}")
    b, n, _ = boxes.shape
    if n > MAX_N:
        raise ValueError(f"self_cluster_cuda: n = {n} > {MAX_N}")
    # the kernel reads valid's bytes and writes each keep flag as a byte,
    # 0 or 1: a bool tensor's storage
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    rep = torch.empty((b, n), dtype=torch.int64, device=boxes.device)
    if b * n == 0:
        return keep, rep
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()          # the kernel reads a box as a float4
    valid = valid.contiguous()
    thr, h, umin, fast = threshold_split_at_least(iou_threshold)
    err = _fn()(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                rep.data_ptr(), b, n, thr, h, umin, int(fast),
                torch.cuda.current_stream(boxes.device).cuda_stream)
    check(err, "dedup")
    self_cluster_cuda.launches += 1
    return keep, rep


self_cluster_cuda.launches = 0
