"""Test loader: host decode/resize onto a static padded canvas (copy of
coin_tpu/data/loader.py's ``Batch``, ``_BaseLoader`` and ``TestLoader``
with the PIL decode path only; the native libjpeg decoder and the train
loader belong to later slices).
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from coin_tpu_torch.data.voc import get_dataset, load_voc_instances

logger = logging.getLogger(__name__)

DECODE_THREADS = 8  # PIL decode/resize release the GIL


@dataclass
class Batch:
    """Host-side batch (numpy)."""
    images: np.ndarray          # (B, H, W, 3) uint8, resized+padded
    image_hw: np.ndarray        # (B, 2) valid (h, w) on the canvas
    orig_hw: np.ndarray         # (B, 2) original image size
    scale: np.ndarray           # (B,) resize factor orig→canvas
    image_ids: List[str]
    indices: np.ndarray         # (B,) dataset indices
    gt_boxes: np.ndarray        # (B, G, 4) canvas coords
    gt_classes: np.ndarray      # (B, G)
    gt_valid: np.ndarray        # (B, G)
    gt_difficult: np.ndarray    # (B, G)


def _resize_factor(h: int, w: int, min_size: int, max_size: int) -> float:
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return scale


class TestLoader:
    """Sequential fixed-batch loader (pads the tail by repeating the last
    index; consumers mask with ``n_valid``)."""

    def __init__(self, dataset_name: str, root: str, batch_size: int = 8,
                 min_size: int = 600, max_size: int = 1333,
                 canvas_hw: Optional[Tuple[int, int]] = None,
                 gt_capacity: int = 64):
        spec = get_dataset(dataset_name)
        self.spec = spec
        self.records = load_voc_instances(
            os.path.join(root, spec.dirname), spec.split, spec.class_names,
            spec.image_ext)
        self.batch_size = batch_size
        self.min_size = min_size
        self.max_size = max_size
        self.gt_capacity = gt_capacity
        self.canvas_hw = canvas_hw or self._infer_canvas()

    def _infer_canvas(self) -> Tuple[int, int]:
        """Resize the largest image shape over all records, round up /32."""
        hs, ws = [], []
        for rec in self.records:
            h, w = rec.get("height"), rec.get("width")
            if h is None:
                with Image.open(rec["file_name"]) as im:
                    w, h = im.size
                rec["height"], rec["width"] = h, w
            s = _resize_factor(h, w, self.min_size, self.max_size)
            hs.append(h * s)
            ws.append(w * s)
        up = lambda v: int(-(-max(v) // 32) * 32)
        return up(hs), up(ws)

    def load_image(self, rec: dict):
        ch, cw = self.canvas_hw
        with Image.open(rec["file_name"]) as im:
            im = im.convert("RGB")
            w, h = im.size
            rec.setdefault("height", h)
            rec.setdefault("width", w)
            scale = _resize_factor(h, w, self.min_size, self.max_size)
            nh, nw = int(round(h * scale)), int(round(w * scale))
            if nh > ch or nw > cw:
                logger.warning("image %s (%dx%d, scaled %dx%d) exceeds the "
                               "static canvas %s; clamping distorts its "
                               "scale", rec.get("image_id"), h, w, nh, nw,
                               self.canvas_hw)
                nh, nw = min(nh, ch), min(nw, cw)
            im = im.resize((nw, nh), Image.BILINEAR)
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[:nh, :nw] = np.asarray(im, np.uint8)
        return canvas, scale, (nh, nw)

    def pack_batch(self, indices: Sequence[int]) -> Batch:
        b, g = len(indices), self.gt_capacity
        images = np.zeros((b, *self.canvas_hw, 3), np.uint8)
        image_hw = np.zeros((b, 2), np.float32)
        orig_hw = np.zeros((b, 2), np.float32)
        scales = np.zeros((b,), np.float32)
        gt_boxes = np.zeros((b, g, 4), np.float32)
        gt_classes = np.full((b, g), -1, np.int32)
        gt_valid = np.zeros((b, g), bool)
        gt_diff = np.zeros((b, g), bool)
        with ThreadPoolExecutor(DECODE_THREADS) as pool:
            loaded = list(pool.map(
                lambda i: self.load_image(self.records[i]), indices))
        ids = []
        for j, i in enumerate(indices):
            rec = self.records[i]
            img, scale, (nh, nw) = loaded[j]
            images[j] = img
            image_hw[j] = (nh, nw)
            orig_hw[j] = (rec["height"], rec["width"])
            scales[j] = scale
            ids.append(rec["image_id"])
            n = min(len(rec["boxes"]), g)
            if n:
                gt_boxes[j, :n] = rec["boxes"][:n] * scale
                gt_classes[j, :n] = rec["classes"][:n]
                gt_valid[j, :n] = True
                gt_diff[j, :n] = rec["difficult"][:n]
        return Batch(images, image_hw, orig_hw, scales, ids,
                     np.asarray(indices), gt_boxes, gt_classes, gt_valid,
                     gt_diff)

    def __len__(self):
        return -(-len(self.records) // self.batch_size)

    def __iter__(self):
        n = len(self.records)
        for start in range(0, n, self.batch_size):
            idx = list(range(start, min(start + self.batch_size, n)))
            n_valid = len(idx)
            while len(idx) < self.batch_size:
                idx.append(idx[-1])
            yield self.pack_batch(idx), n_valid
