"""Box predictor and box inference (counterpart of
coin_tpu/models/roi_heads.py:38-68 and :286-346). Proposal sampling and
the ROI losses belong to the training slice."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from coin_tpu_torch.models.rpn import _take, topk_stable
from coin_tpu_torch.ops import nms as nms_ops
from coin_tpu_torch.structures import Detections

BOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


class BoxPredictor(nn.Module):
    """``trans`` 3-layer MLP (leaky ReLU) → class features (text dim) and
    class-agnostic box deltas; classification is cosine similarity with
    the text features divided by ``logit_scale``. Runs in f32."""

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


def fast_rcnn_inference(boxes: torch.Tensor, scores: torch.Tensor,
                        proposal_valid: torch.Tensor,
                        image_hw: torch.Tensor,
                        score_thresh: float = 0.05,
                        nms_thresh: float = 0.5, topk: int = 100,
                        pre_nms_candidates: int = 1024) -> Detections:
    """``fast_rcnn_inference_single`` over a batch of images.

    boxes (B, R, 4) decoded class-agnostic boxes; scores (B, R, C+1)
    softmax probabilities incl. background; proposal_valid (B, R);
    image_hw (B, 2). Per-class thresholding → the top
    ``pre_nms_candidates`` (row, class) candidates → class-aware NMS →
    top-k, with each kept row's probability vector carried in ``probs``.
    """
    b, r, c1 = scores.shape
    c = c1 - 1
    h = image_hw[:, 0:1, None].to(boxes.dtype)
    w = image_hw[:, 1:2, None].to(boxes.dtype)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    clip = lambda v, hi: torch.minimum(torch.maximum(v, zero), hi)
    boxes = torch.stack([clip(boxes[..., 0], w[..., 0]),
                         clip(boxes[..., 1], h[..., 0]),
                         clip(boxes[..., 2], w[..., 0]),
                         clip(boxes[..., 3], h[..., 0])], dim=-1)

    # (row, class) candidates, row-major
    dev = scores.device
    cand_scores = scores[..., :c].reshape(b, r * c)
    cand_classes = torch.arange(c, dtype=torch.int32, device=dev) \
        .repeat(r).expand(b, -1)
    cand_rows = torch.arange(r, device=dev).repeat_interleave(c) \
        .expand(b, -1)
    cand_boxes = boxes.repeat_interleave(c, dim=1)
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
