"""The GDINO cloud teacher behind the collector's detector interface
(counterpart of coin_tpu/models/gdino_detector.py): captions and positive
maps, the phrase-local text self-attention mask, post-processing and
``GDINODetector``.

Captions are the class names joined by ' . '; each class maps to its
token span (the positive map); per-query sigmoid logits (nq, T) become
per-class probabilities through the normalised positive map; a score
threshold; a background column appended and renormalised with
softmax(log p); boxes cxcywh → xyxy scaled to the image (the reference's
gdino.py:144-203). Post-processing is batched over images.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from coin_tpu_torch import structures as S
from coin_tpu_torch.data.augment import normalize_batch
from coin_tpu_torch.device import resolve_device
from coin_tpu_torch.structures import Detections

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def build_captions_and_spans(class_names: Sequence[str],
                             tokenizer) -> Tuple[str, np.ndarray, list]:
    """caption 'a . b . c .', token ids, and per-class token index spans."""
    caption = " . ".join(n.replace("_", " ") for n in class_names) + " ."
    ids = [tokenizer.cls]
    spans = []
    for name in class_names:
        toks = tokenizer.encode(name.replace("_", " "))
        spans.append((len(ids), len(ids) + len(toks)))
        ids.extend(toks)
        ids.extend(tokenizer.encode("."))
    ids.append(tokenizer.sep)
    return caption, np.asarray(ids, np.int64), spans


def positive_map_from_spans(spans, text_len: int) -> np.ndarray:
    """(C, T) map class → its tokens, each row normalised to sum 1."""
    m = np.zeros((len(spans), text_len), np.float32)
    for c, (s, e) in enumerate(spans):
        m[c, s:e] = 1.0
    norm = m.sum(axis=1, keepdims=True)
    return m / np.maximum(norm, 1.0)


def phrase_self_attention_mask(ids: np.ndarray, sep_ids: Sequence[int],
                               special_ids: Sequence[int]) -> np.ndarray:
    """(T, T) boolean mask: attend within the same '.'-delimited segment;
    special tokens attend only to themselves."""
    t = len(ids)
    seg = np.zeros(t, np.int64)
    cur = 0
    for i, tok in enumerate(ids):
        seg[i] = cur
        if tok in sep_ids:
            cur += 1
    mask = seg[:, None] == seg[None, :]
    for i, tok in enumerate(ids):
        if tok in special_ids:
            mask[i, :] = False
            mask[:, i] = False
            mask[i, i] = True
    return mask


def _renorm_with_bg(probs_fg: torch.Tensor) -> torch.Tensor:
    """Append a zero background column and renormalise with
    softmax(log p): the foreground renormalises to sum 1 and the
    background is exactly 0; an all-zero row becomes uniform over the
    foreground."""
    logp = torch.log(probs_fg.clamp_min(1e-12))
    bg = torch.full(probs_fg.shape[:-1] + (1,), -1e9, dtype=probs_fg.dtype,
                    device=probs_fg.device)
    return torch.softmax(torch.cat([logp, bg], dim=-1), dim=-1)


def _score_order(det: Detections, capacity: int) -> Detections:
    """The valid rows by descending score (stable), then the rest; the
    first ``capacity`` rows."""
    key = torch.where(det.valid, -det.scores,
                      torch.full_like(det.scores, float("inf")))
    order = torch.sort(key, dim=-1, stable=True).indices[..., :capacity]
    return det.gather(order, torch.gather(det.valid, -1, order))


def postprocess_gdino(logits: torch.Tensor, boxes: torch.Tensor,
                      positive_map: torch.Tensor, image_hw: torch.Tensor,
                      threshold: float = 0.25, capacity: int = 900,
                      type_filter: bool = False) -> Detections:
    """logits (B, nq, T) before the sigmoid (non-finite → probability 0);
    boxes (B, nq, 4) normalised cxcywh; positive_map (C, T); image_hw
    (B, 2). Returns padded Detections in image coordinates whose probs
    carry the background column.

    Default: one detection per query at its argmax class, kept when its
    raw (pre-renorm) max probability passes ``threshold``. ``type_filter``
    (USE_DINO_TYPE_FILTER): one detection per (query, class) pair above
    the threshold."""
    b, nq, _ = logits.shape
    sig = torch.sigmoid(logits)
    sig = torch.where(torch.isfinite(logits), sig, torch.zeros_like(sig))
    probs_fg = sig @ positive_map.t()                    # (B, nq, C)
    probs = _renorm_with_bg(probs_fg)                    # (B, nq, C+1)

    h, w = image_hw[:, 0, None], image_hw[:, 1, None]
    cx, cy = boxes[..., 0] * w, boxes[..., 1] * h
    bw, bh = boxes[..., 2] * w, boxes[..., 3] * h
    xyxy = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                       dim=-1)

    if type_filter:
        c = probs_fg.shape[-1]
        dev = logits.device
        keep = (probs_fg > threshold).reshape(b, nq * c)
        classes = torch.arange(c, dtype=torch.int32, device=dev).repeat(nq)
        rows = torch.arange(nq, device=dev).repeat_interleave(c)
        rprobs = probs[:, rows]                          # (B, nq·C, C+1)
        det = Detections(
            boxes=xyxy[:, rows],
            scores=torch.gather(rprobs, -1, classes.long()[None, :, None]
                                .expand(b, -1, 1))[..., 0],
            classes=classes[None].expand(b, -1), valid=keep, probs=rprobs)
        return _score_order(det, capacity)

    raw_scores = probs_fg.amax(dim=-1)
    classes = probs_fg.argmax(dim=-1)
    scores = torch.gather(probs, -1, classes[..., None])[..., 0]
    det = Detections(boxes=xyxy, scores=scores, classes=classes.int(),
                     valid=raw_scores > threshold, probs=probs)
    if capacity != nq:
        det = _score_order(det, capacity)
    return det


class GDINODetector:
    """The collector's detector: ``detect(images_u8 (B, H, W, 3),
    image_hw (B, 2)) → batched Detections`` in canvas coordinates.

    Holds the GroundingDINO model and the BERT module on ``device``. The
    caption's BERT states do not depend on the images, so they are
    computed once here rather than per batch. ``per_class_test``: one
    caption per class, C forwards, concatenated
    (MODEL.TEACHER_CLOUD.PER_CLASS_TEST); ``type_filter``:
    MODEL.TEACHER_CLOUD.USE_DINO_TYPE_FILTER.
    """

    def __init__(self, model, bert, class_names: Sequence[str], tokenizer,
                 threshold: float = 0.25, capacity: int = 256,
                 per_class_test: bool = False, type_filter: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.bert = bert.to(self.device).eval()
        self.threshold, self.capacity = threshold, capacity
        self.per_class_test, self.type_filter = per_class_test, type_filter
        if per_class_test:
            self._sub: List[GDINODetector] = [
                GDINODetector(model, bert, [name], tokenizer, threshold,
                              max(capacity // len(class_names), 16),
                              type_filter=type_filter, device=self.device)
                for name in class_names]
            self._num_classes = len(class_names)
            return
        _, ids, spans = build_captions_and_spans(class_names, tokenizer)
        t = len(ids)
        dev = self.device
        self.text_ids = torch.from_numpy(ids)[None].to(dev)
        self.text_mask = torch.ones((1, t), dtype=torch.bool, device=dev)
        self.positive_map = torch.from_numpy(
            positive_map_from_spans(spans, t)).to(dev)
        self.self_mask = torch.from_numpy(phrase_self_attention_mask(
            ids, tokenizer.encode("."), [tokenizer.cls, tokenizer.sep]))[
                None, None].to(dev)
        with torch.no_grad():
            self.embeds = self.bert(self.text_ids, self.text_mask)

    @torch.no_grad()
    def run(self, images: torch.Tensor, image_hw: torch.Tensor) -> Detections:
        """ImageNet-normalised images (B, H, W, 3) f32 → Detections."""
        b = images.shape[0]
        logits, boxes = self.model(
            images, self.embeds.expand(b, -1, -1),
            self.text_mask.expand(b, -1), self.self_mask.expand(b, -1, -1, -1))
        return postprocess_gdino(logits, boxes, self.positive_map, image_hw,
                                 self.threshold, self.capacity,
                                 self.type_filter)

    def detect(self, images_u8: torch.Tensor,
               image_hw: torch.Tensor) -> Detections:
        if self.per_class_test:
            parts = []
            for ci, sub in enumerate(self._sub):
                det = sub.detect(images_u8, image_hw)
                # class 0 of the sub-run → ci; its (fg, bg) probs spread
                # into the full row
                probs = torch.zeros(det.classes.shape
                                    + (self._num_classes + 1,),
                                    device=det.probs.device)
                probs[..., ci] = det.probs[..., 0]
                probs[..., -1] = det.probs[..., -1]
                parts.append(det.replace(
                    classes=torch.where(det.valid, ci, -1).int(),
                    probs=probs))
            out = parts[0]
            for p in parts[1:]:
                out = S.concatenate(out, p)
            return out
        images = normalize_batch(images_u8, IMAGENET_MEAN, IMAGENET_STD)
        return self.run(images, image_hw)

    __call__ = detect
