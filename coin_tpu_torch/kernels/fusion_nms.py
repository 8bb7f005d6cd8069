"""Launcher of K6, the Probabilistic-Fusion NMS (csrc/fusion_nms.cu).

Counterpart of ``coin_tpu/ops/nms.py:137`` ``fusion_nms``; the plain
PyTorch version and the public function are in
``coin_tpu_torch/ops/nms.py``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from coin_tpu_torch.kernels.build import check, library
from coin_tpu_torch.ops.nms import threshold_split

MAX_ROWS = 1024
MAX_SMEM = 227 * 1024


@functools.cache
def _lib():
    lib = library("fusion_nms")
    fn = lib.coin_fusion_nms
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 \
        + [ctypes.c_float] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.coin_fusion_nms_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.coin_fusion_nms_smem.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=64)
def _smem(n: int, c1: int) -> int:
    return _lib().coin_fusion_nms_smem(n, c1)


@functools.lru_cache(maxsize=64)
def _split(iou_threshold: float):
    """K3's threshold split for the division-free IoU test."""
    thr, h, umin, fast = threshold_split(iou_threshold)
    return thr, h, umin, int(fast)


def fusion_nms_cuda(boxes: torch.Tensor, probs: torch.Tensor,
                    classes: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float, score_method: int,
                    box_method: int):
    """boxes (B, N, 4) f32, probs (B, N, C+1) f32, classes (B, N) int32,
    valid (B, N) bool on one CUDA device; score_method 0 probEn, 1 avg,
    2 max; box_method 0 s-avg, 1 avg, 2 max → (boxes, scores, probs,
    classes int32, valid bool), fused and re-sorted."""
    dev = boxes.device
    if not boxes.is_cuda or any(t.device != dev for t in
                                (probs, classes, valid)):
        raise ValueError("fusion_nms_cuda: every tensor must be on one CUDA "
                         "device")
    if (boxes.dtype != torch.float32 or probs.dtype != torch.float32
            or classes.dtype != torch.int32 or valid.dtype != torch.bool):
        raise TypeError(f"fusion_nms_cuda: boxes {boxes.dtype}, probs "
                        f"{probs.dtype} (f32), classes {classes.dtype} "
                        f"(int32), valid {valid.dtype} (bool)")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or probs.dim() != 3:
        raise ValueError(f"fusion_nms_cuda: boxes {tuple(boxes.shape)}, "
                         f"probs {tuple(probs.shape)}")
    b, n, _ = boxes.shape
    c1 = probs.shape[-1]
    if (probs.shape[:2] != (b, n) or classes.shape != (b, n)
            or valid.shape != (b, n) or n > MAX_ROWS
            or score_method not in (0, 1, 2) or box_method not in (0, 1, 2)):
        raise ValueError(f"fusion_nms_cuda: boxes {tuple(boxes.shape)}, "
                         f"probs {tuple(probs.shape)}, classes "
                         f"{tuple(classes.shape)}, valid {tuple(valid.shape)} "
                         f"(N <= {MAX_ROWS}), methods {score_method}, "
                         f"{box_method}")
    lib = _lib()
    if _smem(n, c1) > MAX_SMEM:
        raise ValueError(f"fusion_nms_cuda: {n} rows of {c1} probs do not "
                         "fit in shared memory")
    boxes, probs = boxes.contiguous(), probs.contiguous()
    if boxes.data_ptr() % 16:             # read as float4
        boxes = boxes.clone()
    classes = classes.contiguous()
    valid = valid.contiguous().view(torch.uint8)
    o_box = torch.empty_like(boxes)
    o_score = torch.empty((b, n), dtype=torch.float32, device=dev)
    o_prob = torch.empty_like(probs)
    o_cls = torch.empty((b, n), dtype=torch.int32, device=dev)
    o_valid = torch.empty((b, n), dtype=torch.bool, device=dev)  # 0 / 1
    if b * n == 0:
        return o_box, o_score, o_prob, o_cls, o_valid
    err = lib.coin_fusion_nms(
        boxes.data_ptr(), probs.data_ptr(), classes.data_ptr(),
        valid.data_ptr(), o_box.data_ptr(), o_score.data_ptr(),
        o_prob.data_ptr(), o_cls.data_ptr(), o_valid.data_ptr(), b, n, c1,
        *_split(iou_threshold), int(score_method), int(box_method),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "fusion_nms")
    fusion_nms_cuda.launches += 1
    return o_box, o_score, o_prob, o_cls, o_valid


fusion_nms_cuda.launches = 0
