"""RPN head, anchor labeling, the RPN losses and proposal prediction
(counterpart of coin_tpu/models/rpn.py:33-223), batched over images.

In the dual-teacher step the anchors are labeled against the A set;
anchors whose best match is a C (private) box are ignored for the cls/loc
losses and become distillation targets whose soft objectness is the C
box's foreground probability mass.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from coin_tpu_torch.models.layers import Conv2d
from coin_tpu_torch.ops import boxes as box_ops
from coin_tpu_torch.ops import losses as L
from coin_tpu_torch.ops import matcher as M
from coin_tpu_torch.ops import nms as nms_ops
from coin_tpu_torch.parallel import mesh_utils
from coin_tpu_torch.structures import Detections

RPN_DELTA_WEIGHTS = (1.0, 1.0, 1.0, 1.0)


class RPNHead(nn.Module):
    """3x3 conv + objectness and delta 1x1 convs (detectron2
    StandardRPNHead)."""

    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = Conv2d(channels, channels, 3, padding=1)
        self.objectness_logits = Conv2d(channels, num_anchors, 1)
        self.anchor_deltas = Conv2d(channels, num_anchors * 4, 1)

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


class RPNTargets(NamedTuple):
    labels: torch.Tensor            # (B, R) int8: -1 ignore / 0 neg / 1 pos
    matched_boxes: torch.Tensor     # (B, R, 4) matched gt box per anchor
    distill_labels: torch.Tensor    # (B, R) bool: anchors distilled from C
    teacher_probs: torch.Tensor     # (B, R) soft objectness target


def label_anchors(anchors: torch.Tensor, gt_a: Detections,
                  gt_c: Optional[Detections], priorities: torch.Tensor,
                  batch_size: int = 256, positive_fraction: float = 0.5,
                  thresholds=(0.3, 0.7)) -> RPNTargets:
    """``label_anchors_single`` over a batch: anchors (R, 4), gt_a (B, Na),
    gt_c (B, Nc) with probs or None, priorities (B, 2, R) uniform draws of
    the (pos, neg) subsampling picks."""
    if gt_c is not None:
        all_boxes = torch.cat([gt_a.boxes, gt_c.boxes], 1)
        all_valid = torch.cat([gt_a.valid, gt_c.valid], 1)
    else:
        all_boxes, all_valid = gt_a.boxes, gt_a.valid
    quality = box_ops.pairwise_iou(all_boxes, anchors[None])
    matched_idx, labels = M.match(quality, all_valid, thresholds,
                                  (0, -1, 1), allow_low_quality=True)
    del quality
    na = gt_a.capacity
    neg1 = torch.full_like(labels, -1)
    if gt_c is not None:
        is_c = matched_idx >= na
        fg_c = is_c & (labels != 0)
        labels = torch.where(fg_c, neg1, labels)
        c_fg_prob = gt_c.probs[..., :-1].sum(-1)
        t_probs = torch.where(
            fg_c, torch.gather(c_fg_prob, 1, (matched_idx - na).clamp_min(0)),
            torch.zeros_like(c_fg_prob[:, :1]))
        distill = fg_c
        matched_idx = torch.where(is_c, torch.zeros_like(matched_idx),
                                  matched_idx)
        fallback = torch.where(is_c & (labels == 0),
                               torch.zeros_like(labels), neg1)
    else:
        distill = torch.zeros_like(labels, dtype=torch.bool)
        t_probs = torch.zeros(labels.shape, device=labels.device)
        fallback = neg1
    # no positive gt at all: everything ignored, except anchors whose best
    # match is a C box yet labeled background
    labels = torch.where(gt_a.valid.any(-1, keepdim=True), labels, fallback)
    pos, neg = M.subsample_labels(labels, batch_size, positive_fraction,
                                  priorities[:, 0], priorities[:, 1])
    labels = torch.where(pos, torch.ones_like(labels),
                         torch.where(neg, torch.zeros_like(labels), neg1))
    idx = matched_idx.clamp(0, na - 1)
    matched_boxes = torch.gather(gt_a.boxes, 1,
                                 idx[..., None].expand(-1, -1, 4))
    return RPNTargets(labels, matched_boxes, distill, t_probs)


def rpn_losses(anchors: torch.Tensor, obj_logits: torch.Tensor,
               deltas: torch.Tensor, targets: RPNTargets,
               batch_size: int = 256, calc_bg: bool = True,
               with_distillation: bool = False) -> dict:
    """Batched RPN losses: obj_logits (B, R), deltas (B, R, 4). In a
    data-parallel step the normalisers count the global batch."""
    labels = targets.labels
    pos = labels == 1
    valid = (labels >= 0) if calc_bg else pos
    counts = mesh_utils.global_sum(
        valid.sum(), *([targets.distill_labels.sum()] if with_distillation
                       else []))
    y = pos.to(obj_logits.dtype)
    bce = -(y * F.logsigmoid(obj_logits)
            + (1.0 - y) * F.logsigmoid(-obj_logits))
    obj_loss = torch.where(valid, bce, torch.zeros_like(bce)).sum()
    normalizer = batch_size * mesh_utils.global_batch(labels.shape[0])
    cls_norm = normalizer if calc_bg else counts[0].clamp_min(1)
    gt_deltas = box_ops.encode_deltas(anchors[None], targets.matched_boxes,
                                      RPN_DELTA_WEIGHTS)
    loc = L.smooth_l1(deltas, gt_deltas, beta=0.0).sum(-1)
    loc_loss = torch.where(pos, loc, torch.zeros_like(loc)).sum()
    out = {"loss_rpn_cls": obj_loss / cls_norm,
           "loss_rpn_loc": loc_loss / normalizer}
    if with_distillation:
        # KL between (q, 1-q) and (p, 1-p) on distilled anchors, averaged
        # over elements (2 per anchor), as torch KLDivLoss('mean')
        p = torch.sigmoid(obj_logits)
        q = targets.teacher_probs
        mask = targets.distill_labels

        def kl_term(qq, pp):
            return qq * (torch.log(qq.clamp_min(1e-20))
                         - torch.log(pp + 1e-7))
        kl = kl_term(q, p) + kl_term(1.0 - q, 1.0 - p)
        cnt = counts[1]
        total = torch.where(mask, kl, torch.zeros_like(kl)).sum()
        out["loss_rpn_distillation"] = torch.where(
            cnt > 0, total / (2.0 * cnt).clamp_min(1.0),
            torch.zeros_like(total))
    return out


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
