"""Host-side packed store of cached cloud-detector results (copy of
coin_tpu/engine/results_store.py, a host module, kept so that the port
imports nothing of coin_tpu).

Replaces the collector caches (coin/modeling/meta_arch/gdino_collector.py:
51-101, clip_collector.py): per image we keep padded arrays of the RCNN and
RPN threshold views in ORIGINAL image coordinates. The train loader
attaches them to each batch already rescaled/flipped to the canvas — no
per-access deepcopies.

Persistence: one .npz per store (GDINO_collect.npz ≙ GDINO_collect.pth).
Multi-host: each process collects its shard and ``merge`` unions the dicts
(the all_gather of gdino_collector.py:72-75 becomes a host-side exchange).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


class ResultStore:
    """image_id → {'<view>_boxes': (N,4), '<view>_classes': (N,),
    '<view>_scores': (N,), '<view>_probs': (N, C+1)} for views RCNN/RPN,
    ragged numpy (unpadded), original image coordinates."""

    VIEWS = ("RCNN", "RPN")

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self._data: Dict[str, Dict[str, np.ndarray]] = {}
        self._overflow = 0        # images whose pack_view overflowed
        self._overflow_boxes = 0  # total boxes dropped by the cap

    def __contains__(self, image_id: str) -> bool:
        return image_id in self._data

    def __len__(self) -> int:
        return len(self._data)

    def put(self, image_id: str, view: str, boxes: np.ndarray,
            classes: np.ndarray, scores: np.ndarray, probs: np.ndarray):
        rec = self._data.setdefault(image_id, {})
        rec[f"{view}_boxes"] = np.asarray(boxes, np.float32).reshape(-1, 4)
        rec[f"{view}_classes"] = np.asarray(classes, np.int32).reshape(-1)
        rec[f"{view}_scores"] = np.asarray(scores, np.float32).reshape(-1)
        rec[f"{view}_probs"] = np.asarray(probs, np.float32).reshape(
            -1, self.num_classes + 1)

    def has_view(self, image_id: str, view: str) -> bool:
        rec = self._data.get(image_id)
        return rec is not None and f"{view}_boxes" in rec

    def get_view(self, image_id: str, view: str) -> Dict[str, np.ndarray]:
        rec = self._data[image_id]
        return {k[len(view) + 1:]: rec[f"{view}_{k2}"]
                for k, k2 in [(f"{view}_boxes", "boxes"),
                              (f"{view}_classes", "classes"),
                              (f"{view}_scores", "scores"),
                              (f"{view}_probs", "probs")]}

    def pack_view(self, image_id: str, view: str, capacity: int,
                  scale: float, flip: bool, canvas_w: float,
                  score_thresh: Optional[float] = None
                  ) -> Dict[str, np.ndarray]:
        """Padded arrays in canvas coordinates (the loader-side equivalent
        of BASE_Trainer.process, coin/engine/base.py:80-126: rescale,
        hflip, and with ``score_thresh`` only the rows scoring at least
        that)."""
        rec = self.get_view(image_id, view)
        boxes = rec["boxes"] * scale
        classes, scores, probs = (rec["classes"], rec["scores"],
                                  rec["probs"])
        if score_thresh is not None:
            keep = scores >= score_thresh
            boxes, classes = boxes[keep], classes[keep]
            scores, probs = scores[keep], probs[keep]
        if flip and len(boxes):
            flipped = boxes.copy()
            flipped[:, 0] = canvas_w - boxes[:, 2]
            flipped[:, 2] = canvas_w - boxes[:, 0]
            boxes = flipped
        if len(boxes) > capacity:
            # stores carry no ordering guarantee — sort by score so the
            # cap keeps the highest-confidence pseudo-labels, and count
            # the overflow instead of truncating silently
            order = np.argsort(-scores, kind="stable")
            boxes, classes = boxes[order], classes[order]
            scores, probs = scores[order], probs[order]
            self._overflow += 1
            self._overflow_boxes += len(boxes) - capacity
            if self._overflow in (1, 100, 10000):
                logger.warning(
                    "pack_view cap %d dropped %d lowest-score boxes for "
                    "%r (%d overflowing images, %d boxes dropped so far)",
                    capacity, len(boxes) - capacity, image_id,
                    self._overflow, self._overflow_boxes)
        n = min(len(boxes), capacity)
        out = {
            "boxes": np.zeros((capacity, 4), np.float32),
            "classes": np.full((capacity,), -1, np.int32),
            "scores": np.zeros((capacity,), np.float32),
            "probs": np.zeros((capacity, self.num_classes + 1), np.float32),
            "valid": np.zeros((capacity,), bool),
        }
        out["boxes"][:n] = boxes[:n]
        out["classes"][:n] = classes[:n]
        out["scores"][:n] = scores[:n]
        out["probs"][:n] = probs[:n]
        out["valid"][:n] = True
        return out

    # ------------------------- persistence ------------------------- #
    def save(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        flat = {"__num_classes__": np.asarray(self.num_classes),
                "__ids__": np.asarray(sorted(self._data), dtype=object)}
        for image_id, rec in self._data.items():
            for k, v in rec.items():
                flat[f"{image_id}::{k}"] = v
        np.savez_compressed(path, **flat)

    @classmethod
    def load(cls, path: str) -> "ResultStore":
        with np.load(path, allow_pickle=True) as z:
            store = cls(int(z["__num_classes__"]))
            for key in z.files:
                if key.startswith("__"):
                    continue
                image_id, field = key.split("::", 1)
                store._data.setdefault(image_id, {})[field] = z[key]
        return store

    def merge(self, other: "ResultStore"):
        self._data.update(other._data)

    def image_ids(self) -> Sequence[str]:
        return list(self._data)
