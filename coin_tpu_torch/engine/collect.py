"""The collection pass, stage 1 of COIN (counterpart of
coin_tpu/engine/collect.py).

- ``collect_cloud``: the cloud detector once over a dataset; per batch
  the Probabilistic-Fusion NMS (CLOUD.NMS_METHOD, kernel K6 on the card)
  or the plain class-aware NMS (K3), batched over images; per image the
  RCNN and RPN score-threshold views (the reference's
  gdino_processor.py:164-302), in original image coordinates, into a
  ResultStore (≙ GDINO_collect.pth).
- ``rescore_with_clip``: a scorer's re-scoring of every cached box:
  classes, scores and probs replaced, background-classified boxes dropped
  (the reference's clip_rcnn.py:106-132).

The detector is a callable ``detect(images_u8, image_hw) → batched
Detections`` in canvas coordinates (``models/gdino_detector``). The extra
collection views of INPUT.TEACHER_CLOUD.COLLECT_AUG ('ZOOM', 'AUG', off
in the paper) are not ported and raise.
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch

from coin_tpu_torch.data.loader import TestLoader
from coin_tpu_torch.device import resolve_device
from coin_tpu_torch.engine.results_store import ResultStore
from coin_tpu_torch.ops import nms as nms_ops
from coin_tpu_torch.structures import Detections

logger = logging.getLogger(__name__)

_NMS_METHODS = {"p": "probEn", "a": "avg", "m": "max"}
_BOX_METHODS = {"s": "s-avg", "a": "avg", "m": "max"}


def parse_nms_method(method: str):
    """The reference's method strings (coin/layers/nms.py:61-82): 'nms'
    or 'mm' → plain hard NMS (None), else (score method, box method)."""
    if method == "nms":
        return None
    if len(method) != 2:
        raise ValueError(f"NMS method {method!r}: 'nms' or two letters")
    score_m = _NMS_METHODS[method[0]]
    box_m = _BOX_METHODS[method[1]]
    if score_m == "max" and box_m == "max":
        return None
    return score_m, box_m


def postprocess(dets: Detections, fusion, collect_nms_thresh: float
                ) -> Detections:
    """The collection NMS over a batch: fusion (K6) or, for plain NMS,
    detectron2's class-aware batched_nms with half-open IoU (K3)."""
    if fusion is not None:
        return nms_ops.fusion_nms(dets, collect_nms_thresh, *fusion)
    keep = nms_ops.nms_keep_mask(dets.boxes, dets.scores, dets.valid,
                                 collect_nms_thresh, classes=dets.classes)
    return dets.mask(keep)


def collect_cloud(detector: Callable, loader: TestLoader, num_classes: int,
                  nms_method: str = "ms", collect_nms_thresh: float = 0.6,
                  rcnn_thresh: float = 0.25, rpn_thresh: float = 0.25,
                  collect_aug: str = "", device="cuda") -> ResultStore:
    """One pass of ``detector`` over ``loader``; detections are stored in
    original image coordinates."""
    if collect_aug:
        raise NotImplementedError(
            f"INPUT.TEACHER_CLOUD.COLLECT_AUG={collect_aug!r}: the zoom and "
            "augmented collection views (engine/zoom_merge) are not ported "
            "(ROADMAP item 17); they are off in the paper")
    device = resolve_device(device)
    store = ResultStore(num_classes)
    fusion = parse_nms_method(nms_method)
    for batch, n_valid in loader:
        with torch.no_grad():
            dets = detector(torch.from_numpy(batch.images).to(device),
                            torch.from_numpy(batch.image_hw).to(device))
            dets = postprocess(dets, fusion, collect_nms_thresh)
        dets = dets.map(lambda t: t.cpu().numpy())
        for i in range(n_valid):
            valid = dets.valid[i]
            ori = {"boxes": dets.boxes[i][valid] / batch.scale[i],
                   "scores": dets.scores[i][valid],
                   "classes": dets.classes[i][valid],
                   "probs": dets.probs[i][valid]}
            for view, thresh in (("RCNN", rcnn_thresh), ("RPN", rpn_thresh)):
                keep = ori["scores"] >= thresh
                store.put(batch.image_ids[i], view, ori["boxes"][keep],
                          ori["classes"][keep], ori["scores"][keep],
                          ori["probs"][keep])
    logger.info("collected cloud results for %d images", len(store))
    return store


def rescore_with_clip(scorer_apply: Callable, store: ResultStore,
                      loader: TestLoader, capacity: int = 128,
                      device="cuda") -> ResultStore:
    """The re-scoring pass. ``scorer_apply(images_u8, boxes)`` returns
    (B, N, C+1) probs for canvas-coordinate boxes."""
    device = resolve_device(device)
    out = ResultStore(store.num_classes)
    bg = store.num_classes
    for batch, n_valid in loader:
        images = torch.from_numpy(batch.images).to(device)
        for view in ("RCNN", "RPN"):
            packs = [store.pack_view(batch.image_ids[i], view, capacity,
                                     float(batch.scale[i]), False,
                                     float(batch.image_hw[i][1]))
                     for i in range(len(batch.image_ids))]
            boxes = torch.from_numpy(np.stack([p["boxes"] for p in packs]))
            with torch.no_grad():
                probs = scorer_apply(images, boxes.to(device))
            probs = probs.cpu().numpy()
            for i in range(n_valid):
                pv = packs[i]
                valid = pv["valid"]
                p = probs[i][valid]
                classes = p.argmax(-1)
                scores = p.max(-1)
                fg = classes != bg      # drop background-classified boxes
                out.put(batch.image_ids[i], view,
                        (pv["boxes"][valid] / batch.scale[i])[fg],
                        classes[fg], scores[fg], p[fg])
    logger.info("re-scored %d images", len(out))
    return out
