"""Box de-duplication and cluster utilities (counterpart of
coin_tpu/ops/dedup.py): masked, shape-static versions of the reference's
``delete_duplicate_boxes``, ``filter_result`` (transitive IoU self-
clustering) and ``online_boxes_merging`` (coin/utils/util.py:434-507).

``self_cluster_index`` and ``self_cluster_mask`` run kernel K11
(csrc/dedup.cu, launched by kernels/dedup.py) on a CUDA tensor and
:func:`self_cluster_index_plain` on a CPU tensor. The plain version repeats
the JAX closure: the adjacency IoU >= thr between valid boxes with the
diagonal set, ⌈log2 n⌉ boolean squarings, and each box's representative is
the lowest index it reaches. The kernel finds the same lowest index by
union-find over the IoU edges of the upper triangle (:func:`nms.iou_at_least`
is its division-free test in PyTorch). Every function takes one image's
rows (n, ...) or a batch of them (B, n, ...).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from coin_tpu_torch.ops import boxes as box_ops
from coin_tpu_torch.structures import Detections


def _lower(n: int, device) -> torch.Tensor:
    return torch.ones((n, n), dtype=torch.bool, device=device).tril(-1)


def duplicate_mask(boxes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """True for rows whose exact box coordinates already appeared at a
    lower index (the first occurrence is kept)."""
    eq = (boxes[..., :, None, :] == boxes[..., None, :, :]).all(-1)
    eq = eq & valid[..., :, None] & valid[..., None, :]
    return (eq & _lower(boxes.shape[-2], boxes.device)).any(-1)


def delete_duplicate_boxes(det: Detections) -> Detections:
    return det.mask(~duplicate_mask(det.boxes, det.valid))


def self_cluster_index_plain(boxes: torch.Tensor, valid: torch.Tensor,
                             iou_threshold: float = 0.95
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K11: (keep, rep) of boxes (..., n, 4) and valid
    (..., n), through JAX's ⌈log2 n⌉ squarings of the adjacency."""
    n = boxes.shape[-2]
    iou = box_ops.pairwise_iou(boxes, boxes)
    adj = (iou >= iou_threshold) & valid[..., :, None] & valid[..., None, :]
    adj = adj | torch.eye(n, dtype=torch.bool, device=boxes.device)
    reach = adj.float()
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        reach = ((reach + reach @ reach) > 0).float()
    rep = reach.argmax(-1)   # the first maximum: the lowest reachable index
    keep = (rep == torch.arange(n, device=boxes.device)) & valid
    return keep, rep


def self_cluster_index(boxes: torch.Tensor, valid: torch.Tensor,
                       iou_threshold: float = 0.95
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster boxes (..., n, 4) at IoU >= thr (the transitive closure over
    the valid rows) → (keep, rep): keep marks each cluster's lowest index,
    rep[i] (int64) is the lowest index of i's cluster (i itself for an
    invalid row, which is never kept). K11 on a CUDA tensor."""
    if boxes.is_cuda:
        from coin_tpu_torch.kernels.dedup import self_cluster_cuda
        lead = boxes.shape[:-2]
        n = boxes.shape[-2]
        keep, rep = self_cluster_cuda(boxes.reshape(-1, n, 4),
                                      valid.reshape(-1, n), iou_threshold)
        return keep.reshape(lead + (n,)), rep.reshape(lead + (n,))
    return self_cluster_index_plain(boxes, valid, iou_threshold)


def self_cluster_mask(det: Detections, iou_threshold: float = 0.95
                      ) -> torch.Tensor:
    """``filter_result`` (util.py:466-482): keep the first member of each
    IoU >= thr cluster of the valid rows."""
    return self_cluster_index(det.boxes, det.valid, iou_threshold)[0]


def online_boxes_merging(online: Detections, offline_matched: Detections,
                         online_matched_idx: torch.Tensor) -> torch.Tensor:
    """util.py:484-507: when one online box is matched by several
    near-identical offline boxes (every coordinate within 1 pixel), keep
    only the first offline partner. Returns a keep mask over the pairs."""
    idx = online_matched_idx
    same_online = idx[..., :, None] == idx[..., None, :]
    b = offline_matched.boxes
    near_ident = ((b[..., :, None, :] - b[..., None, :, :]).abs()
                  < 1.0).all(-1)
    v = offline_matched.valid
    redundant = same_online & near_ident & v[..., :, None] & v[..., None, :]
    lower = _lower(offline_matched.capacity, b.device)
    return v & ~(redundant & lower).any(-1)
