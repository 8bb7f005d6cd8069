"""RPN head and proposal prediction (counterpart of
coin_tpu/models/rpn.py:33-51 and :182-223). Anchor labeling and the RPN
losses belong to the training slice."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from coin_tpu_torch.ops import boxes as box_ops
from coin_tpu_torch.ops import nms as nms_ops
from coin_tpu_torch.structures import Detections

RPN_DELTA_WEIGHTS = (1.0, 1.0, 1.0, 1.0)


class RPNHead(nn.Module):
    """3x3 conv + objectness and delta 1x1 convs (detectron2
    StandardRPNHead)."""

    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feat: torch.Tensor):
        """feat (B, H, W, C) NHWC → objectness (B, H·W·A) and deltas
        (B, H·W·A, 4), f32, ordered row-major then anchor."""
        x = feat.permute(0, 3, 1, 2)
        t = F.relu(self.conv(x))
        obj = self.objectness_logits(t).permute(0, 2, 3, 1)
        deltas = self.anchor_deltas(t).permute(0, 2, 3, 1)
        b = obj.shape[0]
        return (obj.reshape(b, -1).float(),
                deltas.reshape(b, -1, 4).float())


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last dim with ties in index order, as
    ``jax.lax.top_k`` gives them (torch.topk promises no order)."""
    s = torch.sort(x, dim=-1, descending=True, stable=True)
    return s.values[..., :k], s.indices[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: x (B, R, ...) at idx (B, K) → (B, K, ...)."""
    shape = idx.shape + x.shape[2:]
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, idx)


def predict_proposals(anchors: torch.Tensor, obj_logits: torch.Tensor,
                      deltas: torch.Tensor, image_hw: torch.Tensor,
                      pre_nms_topk: int, post_nms_topk: int,
                      nms_thresh: float = 0.7,
                      min_size: float = 0.0) -> Detections:
    """Decode + top-k + NMS → ``post_nms_topk`` proposals per image.

    anchors (R, 4); obj_logits (B, R); deltas (B, R, 4); image_hw (B, 2)
    valid (h, w) on the canvas. Mirrors detectron2
    find_top_rpn_proposals.
    """
    b, r = obj_logits.shape
    k = min(pre_nms_topk, r)
    scores, idx = topk_stable(obj_logits, k)
    boxes = box_ops.decode_deltas(anchors[idx], _take(deltas, idx),
                                  RPN_DELTA_WEIGHTS)
    h = image_hw[:, 0:1].to(boxes.dtype)
    w = image_hw[:, 1:2].to(boxes.dtype)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    valid = ((x2 - x1) > min_size) & ((y2 - y1) > min_size) \
        & torch.isfinite(scores)
    keep = nms_ops.nms_keep_mask(boxes, scores, valid, nms_thresh)
    kept = torch.where(keep, scores, torch.full_like(scores, nms_ops.NEG_INF))
    kk = min(post_nms_topk, k)
    top_scores, top_idx = topk_stable(kept, kk)
    pad = post_nms_topk - kk
    if pad:
        top_scores = F.pad(top_scores, (0, pad), value=nms_ops.NEG_INF)
        top_idx = F.pad(top_idx, (0, pad))
    top_valid = top_scores > nms_ops.NEG_INF / 2
    return Detections(
        boxes=_take(boxes, top_idx),
        scores=torch.where(top_valid, top_scores,
                           torch.zeros_like(top_scores)),
        classes=torch.where(top_valid, 0, -1).to(torch.int32),
        valid=top_valid,
    )
