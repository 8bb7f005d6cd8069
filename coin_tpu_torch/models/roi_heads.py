"""Box predictor, proposal sampling, the ROI losses and box inference
(counterpart of coin_tpu/models/roi_heads.py:38-346), batched over images.

Sampled proposals are a fixed-size block per image with group tags:
0 = A/fg, 1 = B (inconsistent), 2 = background, -1 = padding. Box
regression is class-agnostic (4 delta columns, every shipped config) or
per class (4 · C columns, ``CLS_AGNOSTIC_BBOX_REG: false``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from coin_tpu_torch.models.rpn import _take, topk_stable
from coin_tpu_torch.parallel import mesh_utils
from coin_tpu_torch.ops import boxes as box_ops
from coin_tpu_torch.ops import losses as L
from coin_tpu_torch.ops import matcher as M
from coin_tpu_torch.ops import nms as nms_ops
from coin_tpu_torch.structures import Detections, concatenate

GROUP_A = 0
GROUP_B = 1
GROUP_BG = 2
GROUP_PAD = -1

BOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


class BoxPredictor(nn.Module):
    """``trans`` 3-layer MLP (leaky ReLU) → class features (text dim) and
    box deltas (``box_dim`` 4, or 4 · C per class); classification is
    cosine similarity with the text features divided by ``logit_scale``.
    Runs in f32."""

    def __init__(self, in_dim: int, text_dim: int, box_dim: int = 4,
                 logit_scale: float = 0.01):
        super().__init__()
        self.logit_scale = logit_scale
        self.trans_0 = nn.Linear(in_dim, in_dim // 2)
        self.trans_1 = nn.Linear(in_dim // 2, in_dim // 2)
        self.trans_2 = nn.Linear(in_dim // 2, in_dim)
        self.cls_score = nn.Linear(in_dim, text_dim)
        self.bbox_pred = nn.Linear(in_dim, box_dim)

    def forward(self, x: torch.Tensor):
        h = F.leaky_relu(self.trans_0(x), 0.01)
        h = F.leaky_relu(self.trans_1(h), 0.01)
        h = self.trans_2(h)
        return self.cls_score(h), self.bbox_pred(h)

    def classify(self, class_feats: torch.Tensor,
                 text_features: torch.Tensor) -> torch.Tensor:
        """cosine(image, text) / logit_scale → (N, C+1) raw scores."""
        img = class_feats / torch.linalg.vector_norm(
            class_feats, dim=-1, keepdim=True).clamp_min(1e-8)
        txt = text_features / torch.linalg.vector_norm(
            text_features, dim=-1, keepdim=True).clamp_min(1e-8)
        return (img @ txt.T) / self.logit_scale


class SampledProposals(NamedTuple):
    boxes: torch.Tensor          # (..., S, 4)
    group: torch.Tensor          # (..., S) int8
    gt_boxes: torch.Tensor       # (..., S, 4) matched target box
    cls_offline: torch.Tensor    # (..., S) int32 (bg rows = num_classes)
    cls_online: torch.Tensor     # (..., S) int32
    probs_offline: torch.Tensor  # (..., S, C+1)
    probs_online: torch.Tensor   # (..., S, C+1)


def sample_proposals(proposals: Detections, gt_a: Detections,
                     gt_b: Optional[Detections], gt_c: Optional[Detections],
                     num_classes: int, priorities: torch.Tensor,
                     batch_size: int = 512, positive_fraction: float = 0.25,
                     iou_threshold: float = 0.5,
                     b_cls_online: Optional[torch.Tensor] = None,
                     b_probs_online: Optional[torch.Tensor] = None,
                     bg_train: bool = True) -> SampledProposals:
    """``sample_proposals_single`` over a batch. proposals (B, P); gt_a
    (B, Na) with probs; gt_b (B, Nb) (classes/probs = the offline view,
    with ``b_cls_online`` / ``b_probs_online``) or None; gt_c (B, Nc), whose
    matches are ignored, or None; priorities (B, 2, P + Na + Nb) uniform
    draws of the (pos, neg) picks. The gt boxes (A, then B) join the
    candidates."""
    c1 = num_classes + 1
    cand = concatenate(proposals, gt_a.replace(probs=None))
    if gt_b is not None:
        cand = concatenate(cand, gt_b.replace(probs=None))
    parts = [gt_a] + [g for g in (gt_b, gt_c) if g is not None]
    union_boxes = torch.cat([g.boxes for g in parts], 1)
    union_valid = torch.cat([g.valid for g in parts], 1)
    na = gt_a.capacity
    nb = gt_b.capacity if gt_b is not None else 0

    quality = box_ops.pairwise_iou(union_boxes, cand.boxes)
    quality = torch.where(cand.valid[:, None, :], quality,
                          torch.zeros_like(quality))
    matched_idx, labels = M.match(quality, union_valid, (iou_threshold,),
                                  (0, 1), allow_low_quality=False)
    neg1 = torch.full_like(labels, -1)
    if gt_c is not None:
        fg_c = (matched_idx >= na + nb) & (labels != 0)
        labels = torch.where(fg_c, neg1, labels)
    labels = torch.where(cand.valid, labels, neg1)
    pos, neg = M.subsample_labels(labels, batch_size, positive_fraction,
                                  priorities[:, 0], priorities[:, 1])
    sampled = pos | neg
    order = torch.sort((~sampled).to(torch.uint8), dim=-1,
                       stable=True).indices[:, :batch_size]

    def take(a, idx=order):
        i = idx.reshape(idx.shape + (1,) * (a.dim() - 2))
        return torch.gather(a, 1, i.expand(idx.shape + a.shape[2:]))
    sel_valid = take(sampled)
    boxes = take(cand.boxes)
    midx = take(matched_idx)
    is_pos = take(pos)
    in_a = is_pos & (midx < na)
    in_b = is_pos & (midx >= na) & (midx < na + nb)
    group = torch.full(order.shape, GROUP_PAD, dtype=torch.int8,
                       device=order.device)
    group = torch.where(in_a & sel_valid, GROUP_A, group)
    group = torch.where(in_b & sel_valid, GROUP_B, group)
    if bg_train:
        group = torch.where(take(neg) & sel_valid, GROUP_BG, group)

    a_idx = midx.clamp(0, na - 1)
    gt_boxes = take(gt_a.boxes, a_idx)
    cls_off = take(gt_a.classes, a_idx)
    probs_off = (take(gt_a.probs, a_idx) if gt_a.probs is not None
                 else torch.zeros(order.shape + (c1,), device=order.device))
    cls_on, probs_on = cls_off, probs_off
    if gt_b is not None:
        b_idx = (midx - na).clamp(0, nb - 1)
        inb = in_b[..., None]
        gt_boxes = torch.where(inb, take(gt_b.boxes, b_idx), gt_boxes)
        cls_off = torch.where(in_b, take(gt_b.classes, b_idx), cls_off)
        probs_off = torch.where(inb, take(gt_b.probs, b_idx), probs_off)
        cls_on = torch.where(in_b, take(b_cls_online, b_idx), cls_on)
        probs_on = torch.where(inb, take(b_probs_online, b_idx), probs_on)

    is_fg = (group == GROUP_A) | (group == GROUP_B)
    pad = group == GROUP_PAD

    def label(cls):
        cls = torch.where(is_fg, cls, torch.full_like(cls, num_classes))
        return torch.where(pad, torch.full_like(cls, -1), cls)
    return SampledProposals(boxes, group, gt_boxes, label(cls_off),
                            label(cls_on), probs_off, probs_on)


def one_hot_c1(classes: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(classes.long().clamp(0, num_classes),
                     num_classes + 1).float()


def classification_loss(scores: torch.Tensor, sp: SampledProposals,
                        num_classes: int, bg_weight: float,
                        loss_type: str = "MILCrossEntropy",
                        classes_weight: Optional[torch.Tensor] = None,
                        prob_weighted: bool = False) -> torch.Tensor:
    """MIL CE (or, by CLOUD.LOSS_TYPE, MIL focal) over fg (A) and bg rows.
    ``prob_weighted`` is clipart's variant (``class_cross_loss1``): the
    fg targets scaled by their largest offline probability, MIL CE without
    averaging over the positives."""
    rows = (sp.group == GROUP_A) | (sp.group == GROUP_BG)
    target = one_hot_c1(sp.cls_offline, num_classes)
    weights = torch.where(sp.group == GROUP_BG, bg_weight, 1.0)
    if prob_weighted:
        scale = torch.where(sp.group == GROUP_A,
                            sp.probs_offline.amax(-1), 1.0)
        return L.mil_cross_entropy(scores, target * scale[:, None], rows,
                                   weights=weights, avg_positives=False)
    if loss_type == "MILFocalLoss":
        return L.mil_focal_loss(scores, target, rows, alpha=classes_weight,
                                avg_positives=True)
    return L.mil_cross_entropy(scores, target, rows, weights=weights,
                               avg_positives=True)


def box_reg_loss(sp: SampledProposals, deltas: torch.Tensor,
                 num_classes: int, use_online_classes: bool = True,
                 normalizer=None) -> torch.Tensor:
    """L1 box regression over fg rows, normalised by the sampled count (or
    ``normalizer``). ``deltas`` (S, 4) class-agnostic, or (S, 4 · C) per
    class: each row's own class (online or offline) picks its column,
    clipped to [0, C − 1] (background rows pick column 0 and are masked).
    The sampled count is the global batch's in a data-parallel step."""
    cls = sp.cls_online if use_online_classes else sp.cls_offline
    fg = (cls >= 0) & (cls < num_classes)
    if deltas.shape[-1] != 4:
        per_cls = deltas.reshape(deltas.shape[0], num_classes, 4)
        col = cls.long().clamp(0, num_classes - 1)
        deltas = torch.gather(per_cls, 1,
                              col[:, None, None].expand(-1, 1, 4))[:, 0]
    gt_deltas = box_ops.encode_deltas(sp.boxes, sp.gt_boxes, BOX_REG_WEIGHTS)
    per_row = L.smooth_l1(deltas, gt_deltas, beta=0.0).sum(-1)
    total = torch.where(fg, per_row, torch.zeros_like(per_row)).sum()
    if normalizer is None:
        normalizer = mesh_utils.global_sum(
            (sp.group != GROUP_PAD).sum())[0].clamp_min(1)
    return total / normalizer


def kl_mean_elements(log_p: torch.Tensor, q: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """torch KLDivLoss(reduction='mean') over valid rows: Σ q·(log q −
    log p) / (#valid rows × C), the rows counted over the global batch in
    a data-parallel step."""
    per_elem = q * (torch.log(q.clamp_min(1e-20)) - log_p)
    total = torch.where(valid[:, None], per_elem,
                        torch.zeros_like(per_elem)).sum()
    cnt = mesh_utils.global_sum(valid.sum())[0] * log_p.shape[-1]
    return torch.where(cnt > 0, total / cnt.clamp_min(1),
                       torch.zeros_like(total))


def masked_mse(p: torch.Tensor, q: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    se = (p - q) ** 2
    total = torch.where(valid[:, None], se, torch.zeros_like(se)).sum()
    cnt = mesh_utils.global_sum(valid.sum())[0] * p.shape[-1]
    return torch.where(cnt > 0, total / cnt.clamp_min(1),
                       torch.zeros_like(total))


def fast_rcnn_inference(boxes: torch.Tensor, scores: torch.Tensor,
                        proposal_valid: torch.Tensor,
                        image_hw: torch.Tensor,
                        score_thresh: float = 0.05,
                        nms_thresh: float = 0.5, topk: int = 100,
                        pre_nms_candidates: int = 1024) -> Detections:
    """``fast_rcnn_inference_single`` over a batch of images.

    boxes (B, R, 4) decoded class-agnostic boxes, or (B, R, C, 4) per-class
    boxes (each (row, class) candidate its own box); scores (B, R, C+1)
    softmax probabilities incl. background; proposal_valid (B, R);
    image_hw (B, 2). Per-class thresholding → the top
    ``pre_nms_candidates`` (row, class) candidates → class-aware NMS →
    top-k, with each kept row's probability vector carried in ``probs``.
    """
    b, r, c1 = scores.shape
    c = c1 - 1
    lead = (b,) + (1,) * (boxes.dim() - 2)
    h = image_hw[:, 0].to(boxes.dtype).reshape(lead)
    w = image_hw[:, 1].to(boxes.dtype).reshape(lead)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    clip = lambda v, hi: torch.minimum(torch.maximum(v, zero), hi)
    boxes = torch.stack([clip(boxes[..., 0], w), clip(boxes[..., 1], h),
                         clip(boxes[..., 2], w), clip(boxes[..., 3], h)],
                        dim=-1)

    # (row, class) candidates, row-major
    dev = scores.device
    cand_scores = scores[..., :c].reshape(b, r * c)
    cand_classes = torch.arange(c, dtype=torch.int32, device=dev) \
        .repeat(r).expand(b, -1)
    cand_rows = torch.arange(r, device=dev).repeat_interleave(c) \
        .expand(b, -1)
    cand_boxes = (boxes.repeat_interleave(c, dim=1) if boxes.dim() == 3
                  else boxes.reshape(b, r * c, 4))
    cand_valid = (cand_scores > score_thresh) \
        & proposal_valid.repeat_interleave(c, dim=1)

    if pre_nms_candidates and pre_nms_candidates < r * c:
        masked = torch.where(cand_valid, cand_scores,
                             torch.full_like(cand_scores, nms_ops.NEG_INF))
        _, sel = topk_stable(masked, pre_nms_candidates)
        cand_scores = cand_scores.gather(1, sel)
        cand_classes = cand_classes.gather(1, sel)
        cand_boxes = _take(cand_boxes, sel)
        cand_rows = cand_rows.gather(1, sel)
        cand_valid = cand_valid.gather(1, sel)

    n_cand = cand_scores.shape[1]
    keep = nms_ops.nms_keep_mask(cand_boxes, cand_scores, cand_valid,
                                 nms_thresh, classes=cand_classes)
    kept = torch.where(keep, cand_scores,
                       torch.full_like(cand_scores, nms_ops.NEG_INF))
    top_scores, top_idx = topk_stable(kept, min(topk, n_cand))
    top_valid = top_scores > nms_ops.NEG_INF / 2
    take_rows = cand_rows.gather(1, top_idx)
    return Detections(
        boxes=_take(cand_boxes, top_idx),
        scores=torch.where(top_valid, top_scores,
                           torch.zeros_like(top_scores)),
        classes=torch.where(top_valid, cand_classes.gather(1, top_idx),
                            torch.full_like(top_idx, -1, dtype=torch.int32)),
        valid=top_valid,
        probs=_take(scores, take_rows),
    )
