"""Dual-teacher A/B/C matching as masked tensor math, batched over images
(counterpart of coin_tpu/engine/matching.py:43-138, which is written for
one image and vmapped).

Per image, online = the cached cloud detections O, offline = the EMA
teacher's predictions F:
- each valid online box i takes its best offline match j*(i) among
  {j : IoU(i, j) ≥ thr}, same class first, then IoU;
- A (consistent): pairs with equal classes → the fused box (the online box
  while ``box_a_weight`` is 1, the score-weighted fusion after burn-up);
- B (inconsistent, RCNN view only): pairs with different classes;
- C (private): offline boxes that overlap no online box, then online
  boxes with no offline match;
- degenerate images: no online box → offline boxes scoring > 0.8 become A
  (slots [No, No+Nf)), the rest C; no offline box → every online box is A.

Capacities: A No+Nf, B No, C Nf+No.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coin_tpu_torch.ops import boxes as box_ops
from coin_tpu_torch.ops.nms import weighted_box_fusion_pair
from coin_tpu_torch.structures import Detections


class MatchedSets(NamedTuple):
    a: Detections                   # probs = offline probs
    a_probs_online: torch.Tensor    # (B, No+Nf, C+1)
    b: Detections                   # classes/probs = offline view
    b_cls_online: torch.Tensor      # (B, No)
    b_probs_online: torch.Tensor    # (B, No, C+1)
    c: Detections                   # probs carried (distillation targets)


def _where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """torch.where with ``cond`` (B,) broadcast over a's trailing dims."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)


def match_dual_teacher(online: Detections, offline: Detections,
                       iou_threshold: float, box_a_weight: float,
                       with_b: bool = True) -> MatchedSets:
    """The A/B/C split of a batch of images: online (B, No), offline
    (B, Nf), both with probs."""
    iou = box_ops.pairwise_iou(online.boxes, offline.boxes)   # (B, No, Nf)
    pair_ok = (iou >= iou_threshold) & online.valid[..., :, None] \
        & offline.valid[..., None, :]
    same_cls = online.classes[..., :, None] == offline.classes[..., None, :]
    pref = torch.where(pair_ok, iou + 2.0 * same_cls,
                       torch.full_like(iou, -1.0))
    best, jstar = pref.max(dim=-1)                           # (B, No)
    has_match = best >= 0.0

    any_online = online.valid.any(-1)
    any_offline = offline.valid.any(-1)
    general = any_online & any_offline                       # (B,)
    g = general[:, None]

    def take_off(a):
        idx = jstar.reshape(jstar.shape + (1,) * (a.dim() - 2))
        return torch.gather(a, 1, idx.expand(jstar.shape + a.shape[2:]))
    off_boxes = take_off(offline.boxes)
    off_classes = take_off(offline.classes)
    off_scores = take_off(offline.scores)
    off_probs = take_off(offline.probs)

    fused = online.boxes if box_a_weight >= 1.0 else \
        weighted_box_fusion_pair(online.boxes, off_boxes, online.scores,
                                 off_scores)
    cls_match = has_match & (off_classes == online.classes)
    cls_differ = has_match & (off_classes != online.classes)
    if not with_b:
        cls_differ = torch.zeros_like(cls_differ)

    # A: paired region [0, No), degenerate offline region [No, No+Nf)
    a_valid_pair = g & (cls_match if with_b else has_match)
    deg_off_valid = (~any_online)[:, None] & offline.valid \
        & (offline.scores > 0.8)
    only_online = (any_online & ~any_offline)[:, None]
    a_valid_pair = a_valid_pair | (only_online & online.valid)
    a = Detections(
        boxes=torch.cat([_where(general, fused, online.boxes),
                         offline.boxes], 1),
        scores=torch.cat([_where(general, off_scores, online.scores),
                          offline.scores], 1),
        classes=torch.cat([_where(general, off_classes, online.classes),
                           offline.classes], 1),
        valid=torch.cat([a_valid_pair, deg_off_valid], 1),
        probs=torch.cat([_where(general, off_probs, online.probs),
                         offline.probs], 1),
    )
    a_probs_online = torch.cat([online.probs, offline.probs], 1)

    # B: one slot per online box; drop a B box equal to a valid A box
    b = Detections(boxes=fused, scores=off_scores, classes=off_classes,
                   valid=g & cls_differ, probs=off_probs)
    eq = (b.boxes[:, :, None, :] == a.boxes[:, None, :, :]).all(-1)
    b = b.mask(~(eq & a.valid[:, None, :]).any(-1))

    # C: offline-only slots, then online-only slots
    off_matched = pair_ok.any(dim=-2)
    c_off_valid = torch.where(
        g, offline.valid & ~off_matched,
        (~any_online)[:, None] & offline.valid & (offline.scores <= 0.8))
    c_on_valid = g & online.valid & ~has_match
    c = Detections(
        boxes=torch.cat([offline.boxes, online.boxes], 1),
        scores=torch.cat([offline.scores, online.scores], 1),
        classes=torch.cat([offline.classes, online.classes], 1),
        valid=torch.cat([c_off_valid, c_on_valid], 1),
        probs=torch.cat([offline.probs, online.probs], 1),
    )
    return MatchedSets(a, a_probs_online, b, online.classes, online.probs, c)
