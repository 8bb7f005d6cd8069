"""Exact greedy hard NMS (counterpart of coin_tpu/ops/nms.py:42-131,
``nms_keep_mask``), batched over leading image dims, and the pairwise
score-weighted box fusion of the dual-teacher matching (``:250``).

On a CUDA tensor the sorted-box suppression runs in kernel K3
(csrc/nms.cu, launched by kernels/nms.py); on a CPU tensor it runs in
:func:`nms_sorted_plain`, the plain PyTorch version. Everything around it
is PyTorch: the class offset, the +1 shift of valid rows, the stable
descending score sort and the inverse permutation.
"""

from __future__ import annotations

from typing import Optional

import torch

from coin_tpu_torch.ops import boxes as box_ops

NEG_INF = -1e30


def _offset_by_class(boxes: torch.Tensor, classes: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Shift each class into its own coordinate range (coin_tpu/ops/
    nms.py:42-45); ``max_coord`` is taken per image over valid rows."""
    masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = masked.amax(dim=(-2, -1), keepdim=True)[..., 0]
    return boxes + (classes.to(boxes.dtype) * (max_coord + 1.0))[..., None]


def nms_sorted_plain(sboxes: torch.Tensor, counts: torch.Tensor,
                     iou_threshold: float, plus1: bool) -> torch.Tensor:
    """Plain version of K3. sboxes (B, N, 4) sorted by descending score
    with the ``counts[b]`` valid rows first → keep (B, N) bool."""
    iou_fn = box_ops.pairwise_iou_plus1 if plus1 else box_ops.pairwise_iou
    b, n, _ = sboxes.shape
    keep = torch.zeros((b, n), dtype=torch.bool)
    for i, count in enumerate(counts.tolist()):
        boxes = sboxes[i, :count]
        over = (iou_fn(boxes, boxes) > iou_threshold).triu(1).cpu()
        removed = torch.zeros(count, dtype=torch.bool)
        for r in range(count):
            if not removed[r]:
                removed |= over[r]
        keep[i, :count] = ~removed
    return keep.to(sboxes.device)


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  valid: torch.Tensor, iou_threshold: float,
                  classes: Optional[torch.Tensor] = None,
                  plus1: bool = False) -> torch.Tensor:
    """Greedy NMS keep mask aligned with the input rows.

    boxes (..., N, 4), scores/valid/classes (..., N); class-aware when
    ``classes`` is given (detectron2 batched_nms). Ties in score break by
    input order (stable sort), as in the JAX package.
    """
    lead = boxes.shape[:-2]
    n = boxes.shape[-2]
    boxes = boxes.reshape(-1, n, 4).float()
    scores = scores.reshape(-1, n)
    valid = valid.reshape(-1, n)
    if classes is not None:
        boxes = _offset_by_class(boxes, classes.reshape(-1, n).clamp_min(0),
                                 valid)
    # shift real boxes to strictly positive coordinates and zero the rest,
    # so a zero row never overlaps a real box
    boxes = torch.where(valid[..., None], boxes + 1.0,
                        torch.zeros_like(boxes))
    masked = torch.where(valid, scores.float(),
                         torch.full_like(scores, NEG_INF, dtype=torch.float32))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    # valid rows first even where a valid score is <= NEG_INF: the kernel
    # takes the valid rows as a prefix of length counts[b]
    first = torch.sort((~valid).gather(1, order).to(torch.uint8), dim=-1,
                       stable=True).indices
    order = order.gather(1, first)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    counts = valid.sum(-1, dtype=torch.int32)
    if boxes.is_cuda:
        from coin_tpu_torch.kernels.nms import nms_sorted_cuda
        keep_sorted = nms_sorted_cuda(sboxes, counts, iou_threshold, plus1)
    else:
        keep_sorted = nms_sorted_plain(sboxes, counts, iou_threshold, plus1)
    keep = torch.empty_like(keep_sorted)
    keep.scatter_(1, order, keep_sorted)
    return (keep & valid).reshape(lead + (n,))


def weighted_box_fusion_pair(box_a: torch.Tensor, box_b: torch.Tensor,
                             score_a: torch.Tensor,
                             score_b: torch.Tensor) -> torch.Tensor:
    """Score-weighted average of two aligned box sets
    (coin_tpu/ops/nms.py:250)."""
    total = (score_a + score_b).clamp_min(1e-20)
    wa = (score_a / total)[..., None]
    wb = (score_b / total)[..., None]
    return box_a * wa + box_b * wb
