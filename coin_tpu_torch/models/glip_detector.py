"""The GLIP cloud teacher behind the collector's detector interface
(counterpart of coin_tpu/models/glip_detector.py): ATSS-style anchors,
post-processing and ``GLIPDetector``.

The caption is the class names joined by ' . ' (``gdino_detector``'s
captions and spans); a class's score at an anchor is the max of the
sigmoid token logits over the class's tokens, times the sigmoid of the
centerness; the best class per anchor, the stable top-1000, deltas decoded
at (10, 10, 5, 5) and clipped to the image, class-aware greedy NMS (K3),
the kept rows first up to the capacity, and probabilities synthesised from
the scores (the reference's glip.py:96-105). Post-processing is batched
over images.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from coin_tpu_torch.data.augment import normalize_batch
from coin_tpu_torch.device import resolve_device
from coin_tpu_torch.models.gdino_detector import (IMAGENET_MEAN, IMAGENET_STD,
                                                  build_captions_and_spans,
                                                  positive_map_from_spans)
from coin_tpu_torch.models.gdino_variants import synthetic_probs
from coin_tpu_torch.models.layers import cached_constant
from coin_tpu_torch.models.rpn import topk_stable
from coin_tpu_torch.ops import boxes as box_ops
from coin_tpu_torch.ops import nms as nms_ops
from coin_tpu_torch.structures import Detections

ANCHOR_SIZES = (64, 128, 256, 512, 1024)   # one anchor per cell and level
STRIDES = (8, 16, 32, 64, 128)
DELTA_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def glip_anchors(shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """(ΣHW, 4) xyxy anchors of every level, centred on its cells."""
    out = []
    for (h, w), stride, size in zip(shapes, STRIDES, ANCHOR_SIZES):
        sy, sx = np.meshgrid(np.arange(h) * stride + stride // 2,
                             np.arange(w) * stride + stride // 2,
                             indexing="ij")
        half = size / 2.0
        a = np.stack([sx - half, sy - half, sx + half, sy + half],
                     axis=-1).reshape(-1, 4)
        out.append(a.astype(np.float32))
    return np.concatenate(out, axis=0)


def postprocess_glip(logits: torch.Tensor, deltas: torch.Tensor,
                     centerness: torch.Tensor, anchors: torch.Tensor,
                     positive_map: torch.Tensor, image_hw: torch.Tensor,
                     num_classes: int, threshold: float = 0.25,
                     pre_topk: int = 1000, capacity: int = 256,
                     nms_thresh: float = 0.6) -> Detections:
    """logits (B, R, T) f32; deltas (B, R, 4); centerness (B, R); anchors
    (R, 4); positive_map (C, T); image_hw (B, 2) → padded Detections
    (B, min(k, capacity)) in image coordinates with synthetic probs."""
    sig = torch.sigmoid(logits)
    pm = positive_map > 0
    cls_scores = torch.where(pm[None, None], sig[:, :, None, :],
                             torch.zeros((), device=sig.device)).amax(-1)
    cls_scores = cls_scores * torch.sigmoid(centerness)[..., None]
    scores = cls_scores.amax(-1)
    classes = cls_scores.argmax(-1).int()

    k = min(pre_topk, scores.shape[-1])
    top_scores, idx = topk_stable(scores, k)
    boxes = box_ops.decode_deltas(
        anchors[idx], torch.gather(deltas, 1, idx[..., None].expand(-1, -1,
                                                                    4)),
        DELTA_WEIGHTS)
    hw = image_hw[:, None, :].to(boxes.dtype)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    boxes = torch.stack(
        [torch.minimum(torch.maximum(boxes[..., i], zero), hw[..., 1 - i % 2])
         for i in range(4)], dim=-1)
    cls_top = torch.gather(classes, 1, idx)
    valid = top_scores > threshold
    keep = nms_ops.nms_keep_mask(boxes, top_scores, valid, nms_thresh,
                                 classes=cls_top)
    det = Detections(boxes=boxes,
                     scores=torch.where(keep, top_scores,
                                        torch.zeros_like(top_scores)),
                     classes=torch.where(keep, cls_top,
                                         torch.full_like(cls_top, -1)),
                     valid=keep, probs=None)
    order = torch.sort((~keep).to(torch.uint8), dim=-1,
                       stable=True).indices[..., :capacity]
    det = det.gather(order, torch.gather(keep, 1, order))
    return det.replace(probs=synthetic_probs(det.classes, det.scores,
                                             num_classes, det.valid))


class GLIPDetector:
    """The collector's detector: ``detect(images_u8 (B, H, W, 3),
    image_hw (B, 2)) → batched Detections`` in canvas coordinates.

    Holds the GLIP model and the BERT module on ``device``; the caption's
    BERT states are computed once here, not per batch. The ImageNet
    normalisation is kernel K4n."""

    def __init__(self, model, bert, class_names: Sequence[str], tokenizer,
                 threshold: float = 0.25, capacity: int = 256,
                 device="cuda"):
        self.device = dev = resolve_device(device)
        self.model = model.to(dev).eval()
        self.bert = bert.to(dev).eval()
        self.num_classes = len(class_names)
        self.threshold, self.capacity = threshold, capacity
        _, ids, spans = build_captions_and_spans(class_names, tokenizer)
        self.text_ids = torch.from_numpy(ids)[None].to(dev)
        self.text_mask = torch.ones((1, len(ids)), dtype=torch.bool,
                                    device=dev)
        self.positive_map = torch.from_numpy(
            positive_map_from_spans(spans, len(ids))).to(dev)
        with torch.no_grad():
            self.embeds = self.bert(self.text_ids, self.text_mask)

    @torch.no_grad()
    def run(self, images: torch.Tensor, image_hw: torch.Tensor) -> Detections:
        """ImageNet-normalised images (B, H, W, 3) f32 → Detections."""
        b = images.shape[0]
        logits, deltas, centerness, shapes = self.model(
            images, self.embeds.expand(b, -1, -1),
            self.text_mask.expand(b, -1))
        return self.postprocess(logits, deltas, centerness, shapes, image_hw)

    def postprocess(self, logits, deltas, centerness, shapes, image_hw):
        anchors = cached_constant(("glip_anchors",) + tuple(shapes),
                                  lambda: glip_anchors(shapes),
                                  logits.device)
        return postprocess_glip(logits, deltas, centerness, anchors,
                                self.positive_map, image_hw,
                                self.num_classes, self.threshold,
                                capacity=self.capacity)

    def detect(self, images_u8: torch.Tensor,
               image_hw: torch.Tensor) -> Detections:
        images = normalize_batch(images_u8, IMAGENET_MEAN, IMAGENET_STD)
        return self.run(images, image_hw)

    __call__ = detect
