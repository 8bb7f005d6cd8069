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
Detections`` in canvas coordinates (``models/gdino_detector``). In a
process group each rank passes a loader of its whole batches
(``TestLoader(rank=, world=)``: under INT8_COLLECT a batch shares its
int8 scales, so a batch never splits) and both passes return the union
of the ranks' stores on every rank.
INPUT.TEACHER_CLOUD.COLLECT_AUG adds the reference's extra collection
views (gdino_processor.py:184-302; off in the paper): 'ZOOM' detects a
centre crop again and merges it into the original view
(``engine/zoom_merge``), 'AUG' appends the detections of the strong view
(K4 with the identity normalisation) to the RPN view; 'ZOOM&AUG' both.
Neither view goes through the collection NMS.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch

from coin_tpu_torch.data.augment import draw_augment, strong_view_u8
from coin_tpu_torch.data.loader import TestLoader
from coin_tpu_torch.device import resolve_device
from coin_tpu_torch.engine import zoom_merge
from coin_tpu_torch.engine.results_store import ResultStore
from coin_tpu_torch.ops import nms as nms_ops
from coin_tpu_torch.parallel.multihost import merge_result_stores
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
                  collect_aug: str = "", min_zoom: int = 320,
                  aug_draws: Optional[torch.Tensor] = None,
                  device="cuda") -> ResultStore:
    """One pass of ``detector`` over ``loader``; detections are stored in
    original image coordinates.

    collect_aug: '' | 'ZOOM' | 'AUG' | 'ZOOM&AUG'. ZOOM detects the
    centre crop of short side ``min_zoom`` (canvas pixels) of each image,
    at the top left of a zeroed canvas, and merges it into the original
    view. AUG detects the strong view under ``aug_draws`` (B, 9), one set
    for every batch as JAX splits ``jax.random.key(0)`` afresh for each
    (drawn from a generator seeded 0 when None), and appends its rows
    scoring ``rpn_thresh`` or more to the RPN view."""
    device = resolve_device(device)
    store = ResultStore(num_classes)
    fusion = parse_nms_method(nms_method)
    use_zoom = "ZOOM" in collect_aug
    use_aug = "AUG" in collect_aug
    if use_aug and aug_draws is None:
        aug_draws = draw_augment(torch.Generator().manual_seed(0),
                                 loader.batch_size)
    to_np = lambda d: d.map(lambda t: t.cpu().numpy())
    for batch, n_valid in loader:
        images = torch.from_numpy(batch.images).to(device)
        image_hw = torch.from_numpy(batch.image_hw).to(device)
        aug_dets = zoom_dets = None
        zoom_geom = []
        with torch.no_grad():
            dets = detector(images, image_hw)
            if use_aug:
                aug_dets = to_np(detector(
                    strong_view_u8(images, aug_draws), image_hw))
            if use_zoom:
                crops = np.zeros_like(batch.images)
                for i in range(len(crops)):
                    ch, cw = (int(v) for v in batch.image_hw[i])
                    x1, y1, zw, zh = zoom_merge.center_zoom_box(ch, cw,
                                                                min_zoom)
                    zoom_geom.append((x1, y1, zw, zh))
                    crops[i, :zh, :zw] = batch.images[i, y1:y1 + zh,
                                                      x1:x1 + zw]
                zoom_hw = torch.tensor([[g[3], g[2]] for g in zoom_geom],
                                       dtype=torch.float32)
                zoom_dets = to_np(detector(torch.from_numpy(crops).to(device),
                                           zoom_hw.to(device)))
            dets = postprocess(dets, fusion, collect_nms_thresh)
        dets = to_np(dets)
        for i in range(n_valid):
            valid = dets.valid[i]
            s = batch.scale[i]
            ori = {"boxes": dets.boxes[i][valid] / s,
                   "scores": dets.scores[i][valid],
                   "classes": dets.classes[i][valid],
                   "probs": dets.probs[i][valid]}
            if zoom_dets is not None:
                zvalid = zoom_dets.valid[i]
                x1, y1, zw, zh = zoom_geom[i]
                zoom = {"boxes": (zoom_dets.boxes[i][zvalid]
                                  + np.asarray([x1, y1, x1, y1])) / s,
                        "scores": zoom_dets.scores[i][zvalid],
                        "classes": zoom_dets.classes[i][zvalid],
                        "probs": zoom_dets.probs[i][zvalid]}
                ori = zoom_merge.merge_zoom(
                    ori, zoom, (int(x1 / s), int(y1 / s), int(zw / s),
                                int(zh / s)))
            for view, thresh in (("RCNN", rcnn_thresh), ("RPN", rpn_thresh)):
                keep = ori["scores"] >= thresh
                rows = [ori[k][keep] for k in
                        ("boxes", "classes", "scores", "probs")]
                if view == "RPN" and aug_dets is not None:
                    avalid = aug_dets.valid[i]
                    akeep = aug_dets.scores[i][avalid] >= thresh
                    extra = [(aug_dets.boxes[i][avalid] / s)[akeep]] + [
                        getattr(aug_dets, k)[i][avalid][akeep]
                        for k in ("classes", "scores", "probs")]
                    rows = [np.concatenate([a, b])
                            for a, b in zip(rows, extra)]
                store.put(batch.image_ids[i], view, *rows)
    store = merge_result_stores(store)
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
    out = merge_result_stores(out)
    logger.info("re-scored %d images", len(out))
    return out
