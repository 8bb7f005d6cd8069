"""Data loaders: host decode/resize onto a static padded canvas (copy of
coin_tpu/data/loader.py's ``Batch``, ``_BaseLoader``, ``TestLoader`` and
``TrainLoader``). A batch of JPEGs is decoded by the port's native
libjpeg decoder (``coin_tpu_torch.native``) where it builds, else, and for
any other format, by PIL on a shared thread pool, in the JAX loaders'
order, so that both packages see the same pixels. Everything photometric
happens on the device (``data/augment.py``).

Data parallel: ``TrainLoader(rank=, world=)`` yields rank ``rank``'s
shard of the global batch sequence that one seed gives (its B / W images
of each global batch of B, decoded alone), and ``TestLoader(rank=,
world=)`` the whole batches j with j mod W = rank.
"""

from __future__ import annotations

import logging
import os
import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from coin_tpu_torch import native
from coin_tpu_torch.data.voc import get_dataset, load_voc_instances

logger = logging.getLogger(__name__)

# PIL decode/resize release the GIL; one shared pool (its threads start at
# the first batch) decodes every loader's batches
_DECODE_POOL = ThreadPoolExecutor(max_workers=8)


@dataclass
class Batch:
    """Host-side batch (numpy)."""
    images: np.ndarray          # (B, H, W, 3) uint8, resized+padded
    image_hw: np.ndarray        # (B, 2) valid (h, w) on the canvas
    orig_hw: np.ndarray         # (B, 2) original image size
    scale: np.ndarray           # (B,) resize factor orig→canvas
    flip: np.ndarray            # (B,) bool (train only)
    image_ids: List[str]
    indices: np.ndarray         # (B,) dataset indices
    gt_boxes: np.ndarray        # (B, G, 4) canvas coords
    gt_classes: np.ndarray      # (B, G)
    gt_valid: np.ndarray        # (B, G)
    gt_difficult: np.ndarray    # (B, G)
    # cached cloud views attached by a ResultStore-backed TrainLoader:
    # {"RCNN": {boxes, classes, scores, probs, valid}, "RPN": {...}}, each
    # batched (B, cap, ...) in canvas coordinates
    online: Optional[dict] = None


def _resize_factor(h: int, w: int, min_size: int, max_size: int) -> float:
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return scale


class _BaseLoader:
    def __init__(self, dataset_name: str, root: str, min_size: int = 600,
                 max_size: int = 1333,
                 canvas_hw: Optional[Tuple[int, int]] = None,
                 gt_capacity: int = 64):
        spec = get_dataset(dataset_name)
        self.spec = spec
        self.records = load_voc_instances(
            os.path.join(root, spec.dirname), spec.split, spec.class_names,
            spec.image_ext)
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

    def load_image(self, rec: dict, canvas_hw=None):
        """PIL decode and bilinear resize of one image into the top left of
        a zeroed canvas (``self.canvas_hw`` unless given) → (canvas, scale,
        (nh, nw))."""
        ch, cw = canvas_hw or self.canvas_hw
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
                               (ch, cw))
                nh, nw = min(nh, ch), min(nw, cw)
            im = im.resize((nw, nh), Image.BILINEAR)
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[:nh, :nw] = np.asarray(im, np.uint8)
        return canvas, scale, (nh, nw)

    def _native_decode(self, indices: Sequence[int], canvas_hw=None):
        """The batch through the native decoder: ((canvases, out_hw),
        scales), with ``decode_batch``'s None in place of the pair when an
        image failed; None when the library is unavailable or a file is not
        a JPEG. A record without its size takes it from the JPEG's
        header."""
        if not native.available():
            return None
        blobs, scales = [], []
        for i in indices:
            rec = self.records[i]
            if not rec["file_name"].lower().endswith((".jpg", ".jpeg")):
                return None
            with open(rec["file_name"], "rb") as f:
                blob = f.read()
            if "height" not in rec:
                hw = native.jpeg_size(blob)
                if hw is None:
                    return None
                rec["height"], rec["width"] = hw
            blobs.append(blob)
            scales.append(_resize_factor(rec["height"], rec["width"],
                                         self.min_size, self.max_size))
        return native.decode_batch(blobs, scales,
                                   canvas_hw or self.canvas_hw), scales

    def pack_batch(self, indices: Sequence[int],
                   flips: Optional[np.ndarray] = None,
                   canvas_hw: Optional[Tuple[int, int]] = None) -> Batch:
        b, g = len(indices), self.gt_capacity
        ch, cw = canvas_hw or self.canvas_hw
        images = np.zeros((b, ch, cw, 3), np.uint8)
        image_hw = np.zeros((b, 2), np.float32)
        orig_hw = np.zeros((b, 2), np.float32)
        scales = np.zeros((b,), np.float32)
        gt_boxes = np.zeros((b, g, 4), np.float32)
        gt_classes = np.full((b, g), -1, np.int32)
        gt_valid = np.zeros((b, g), bool)
        gt_diff = np.zeros((b, g), bool)
        flips = (np.zeros(b, bool) if flips is None
                 else np.asarray(flips, bool))
        nat = self._native_decode(indices, (ch, cw))
        if nat is not None and nat[0] is not None:
            (canvases, out_hw), nat_scales = nat
            loaded = [(canvases[j], nat_scales[j],
                       (int(out_hw[j][0]), int(out_hw[j][1])))
                      for j in range(b)]
        else:
            loaded = list(_DECODE_POOL.map(
                lambda i: self.load_image(self.records[i], (ch, cw)),
                indices))
        ids = []
        for j, i in enumerate(indices):
            rec = self.records[i]
            img, scale, (nh, nw) = loaded[j]
            images[j] = img
            if flips[j]:
                # flip the VALID region only (the reference flips before
                # padding to the canvas), and the boxes around nw
                images[j, :nh, :nw] = images[j, :nh, :nw][:, ::-1]
            image_hw[j] = (nh, nw)
            orig_hw[j] = (rec["height"], rec["width"])
            scales[j] = scale
            ids.append(rec["image_id"])
            n = min(len(rec["boxes"]), g)
            if n:
                boxes = rec["boxes"][:n] * scale
                if flips[j]:
                    flipped = boxes.copy()
                    flipped[:, 0] = nw - boxes[:, 2]
                    flipped[:, 2] = nw - boxes[:, 0]
                    boxes = flipped
                gt_boxes[j, :n] = boxes
                gt_classes[j, :n] = rec["classes"][:n]
                gt_valid[j, :n] = True
                gt_diff[j, :n] = rec["difficult"][:n]
        return Batch(images, image_hw, orig_hw, scales, flips, ids,
                     np.asarray(indices), gt_boxes, gt_classes, gt_valid,
                     gt_diff)


class TestLoader(_BaseLoader):
    """Sequential fixed-batch loader (pads the tail by repeating the last
    index; consumers mask with ``n_valid``). With ``world`` > 1 it yields
    the batches j of its ``rank`` (j mod world = rank), whole."""

    def __init__(self, dataset_name: str, root: str, batch_size: int = 8,
                 rank: int = 0, world: int = 1, **kw):
        super().__init__(dataset_name, root, **kw)
        self.batch_size = batch_size
        self.rank, self.world = rank, world

    def __len__(self):
        return -(-len(self.records) // self.batch_size)

    def __iter__(self):
        n = len(self.records)
        for j, start in enumerate(range(0, n, self.batch_size)):
            if j % self.world != self.rank:
                continue
            idx = list(range(start, min(start + self.batch_size, n)))
            n_valid = len(idx)
            while len(idx) < self.batch_size:
                idx.append(idx[-1])
            yield self.pack_batch(idx), n_valid


class TrainLoader(_BaseLoader):
    """Infinite shuffled loader with random horizontal flips and a
    background prefetch thread. The order, the groups and the flips come
    from ``np.random.RandomState(seed)`` in the JAX loader's sequence of
    draws, so both packages see the same batches for one seed. With
    ``aspect_buckets`` every batch is drawn from the landscape or the
    portrait images, each group on a canvas of its own. With ``world`` >
    1, ``batch_size`` is the global batch and each batch holds rank
    ``rank``'s B / W images of it (every rank draws the whole sequence)."""

    def __init__(self, dataset_name: str, root: str, batch_size: int = 3,
                 seed: int = 2024, flip: bool = True, prefetch: int = 2,
                 store=None, store_cap: int = 128,
                 store_thresh: Optional[float] = None,
                 aspect_buckets: bool = False, rank: int = 0,
                 world: int = 1, **kw):
        if world > 1 and batch_size % world:
            raise ValueError(f"TrainLoader: a world of {world} does not "
                             f"divide the batch of {batch_size}")
        super().__init__(dataset_name, root, **kw)
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.rng = np.random.RandomState(seed)
        self.flip = flip
        self.prefetch = prefetch
        self.store = store
        self.store_cap = store_cap
        self.store_thresh = store_thresh
        self.aspect_buckets = aspect_buckets

    def _attach_store(self, batch: Batch) -> Batch:
        """Pack the cached cloud results of each image, rescaled and
        flipped to the canvas (only rows scoring ``store_thresh`` or more
        when it is set)."""
        views = {}
        for view in ("RCNN", "RPN"):
            per_img = [self.store.pack_view(
                batch.image_ids[j], view, self.store_cap,
                float(batch.scale[j]), bool(batch.flip[j]),
                float(batch.image_hw[j][1]), self.store_thresh)
                for j in range(len(batch.image_ids))]
            views[view] = {k: np.stack([p[k] for p in per_img])
                           for k in per_img[0]}
        batch.online = views
        return batch

    def _aspect_groups(self):
        """The landscape (w >= h) and portrait indices, empty groups
        dropped (the reference's AspectRatioGroupedDatasetTwoCrop,
        coin/data/common.py:4-48)."""
        land, port = [], []
        for i, rec in enumerate(self.records):
            h, w = rec.get("height"), rec.get("width")
            if h is None:
                with Image.open(rec["file_name"]) as im:
                    w, h = im.size
                rec["height"], rec["width"] = h, w
            (land if w >= h else port).append(i)
        return [g for g in (land, port) if g]

    def _group_canvas(self, gi: int):
        return self._canvases[gi] if self.aspect_buckets else self.canvas_hw

    def _gen(self):
        groups = self._aspect_groups() if self.aspect_buckets \
            else [list(range(len(self.records)))]
        if self.aspect_buckets:
            # each group's canvas: its largest resized extent, up to /32
            up = lambda v: int(-(-v // 32) * 32)
            self._canvases = []
            for g in groups:
                hs, ws = [], []
                for i in g:
                    rec = self.records[i]
                    sc = _resize_factor(rec["height"], rec["width"],
                                        self.min_size, self.max_size)
                    hs.append(rec["height"] * sc)
                    ws.append(rec["width"] * sc)
                self._canvases.append((up(max(hs)), up(max(ws))))
        orders = [self.rng.permutation(g) for g in groups]
        pos = [0] * len(groups)
        weights = np.asarray([len(g) for g in groups], np.float64)
        weights = weights / weights.sum()
        while True:
            gi = int(self.rng.choice(len(groups), p=weights))
            if pos[gi] + self.batch_size > len(groups[gi]):
                orders[gi] = self.rng.permutation(groups[gi])
                pos[gi] = 0
                if len(groups[gi]) < self.batch_size:
                    # tiny group: sample with replacement
                    idx = self.rng.choice(groups[gi], self.batch_size)
                else:
                    idx = orders[gi][:self.batch_size]
                    pos[gi] = self.batch_size
            else:
                idx = orders[gi][pos[gi]:pos[gi] + self.batch_size]
                pos[gi] += self.batch_size
            flips = (self.rng.rand(len(idx)) < 0.5) if self.flip \
                else np.zeros(len(idx), bool)
            if self.world > 1:
                per = self.batch_size // self.world
                mine = slice(self.rank * per, (self.rank + 1) * per)
                idx, flips = idx[mine], flips[mine]
            batch = self.pack_batch(idx, flips, self._group_canvas(gi))
            if self.store is not None:
                batch = self._attach_store(batch)
            yield batch

    def __iter__(self):
        q = queue_mod.Queue(maxsize=self.prefetch)
        gen = self._gen()

        def worker():
            for item in gen:
                q.put(item)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            yield q.get()
