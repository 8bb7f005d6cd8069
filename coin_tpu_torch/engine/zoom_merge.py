"""The ZOOM collection view's geometry and merge, host-side numpy
(counterpart of coin_tpu/engine/zoom_merge.py, after the reference's
GDINO_PROCESSOR.post_process, coin/modeling/meta_arch/gdino_processor.py
:184-302). It runs once per image at collection time; the probability
and box fusions are the port's ``ops/nms`` functions on CPU tensors.

All detection dicts are {boxes (n, 4), scores (n,), classes (n,), probs
(n, C+1)} in original-image coordinates.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from coin_tpu_torch.ops.nms import (merge_probs_bayesian, merge_probs_max,
                                    weighted_box_fusion_pair)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def _take(det: Dict, idx) -> Dict:
    return {k: det[k][idx] for k in ("boxes", "scores", "classes", "probs")}


def _cat(*dets) -> Dict:
    return {k: np.concatenate([d[k] for d in dets], axis=0)
            for k in ("boxes", "scores", "classes", "probs")}


def _count(stats: Optional[Dict[str, int]], **counts) -> None:
    if stats is not None:
        for k, v in counts.items():
            stats[k] = stats.get(k, 0) + int(v)


def _f32(x: np.ndarray) -> torch.Tensor:
    """A float32 CPU tensor, as ``jnp.asarray`` gives JAX's functions."""
    return torch.from_numpy(np.asarray(x, np.float32))


def center_zoom_box(h: int, w: int, min_zoom: int = 320
                    ) -> Tuple[int, int, int, int]:
    """The centre crop (x1, y1, w, h) of an h x w image: aspect kept, the
    short side ``min_zoom``, clipped to the image (the reference's
    GDINOZOOM, coin/data/transforms/augmentation_impl.py:46-61)."""
    ratio = w / h
    if ratio >= 1:
        cw = int(round(min_zoom * ratio))
        ch = min_zoom
    else:
        cw = min_zoom
        ch = int(round(min_zoom / ratio))
    cw = min(cw, w)
    ch = min(ch, h)
    y1 = (h - ch) // 2
    x1 = (w - cw) // 2
    return x1, y1, cw, ch


def merge_zoom(ori: Dict, zoom: Dict, zoom_xywh: Tuple[int, int, int, int],
               match_thresh: float = 0.6, border_px: float = 5.0,
               stats: Optional[Dict[str, int]] = None) -> Dict:
    """Merge the ZOOM view's detections into the original view's:

    1. original boxes wholly outside the zoom are kept;
    2. border boxes (cut by the zoom window) keep their geometry, and take
       the Bayesian fusion of their probs with a matching zoom box's when
       the fusion keeps their class;
    3. interior boxes must be confirmed by a zoom match: a class mismatch
       takes the zoom row whole, a class match the score-weighted box and
       the max-fused probs;
    4. zoom-only boxes are appended, save those at the crop's border that
       overlap an original border box.

    ``stats``, when given, adds up the rows of each case: ``kept``
    (outside), ``border``, ``border_fused``, ``fused`` (confirmed, same
    class), ``replaced`` (confirmed, another class), ``dropped``
    (unconfirmed interior) and ``appended``.
    """
    if len(zoom["boxes"]) == 0:
        _count(stats, kept=len(ori["boxes"]))
        return ori
    x1, y1, cw, ch = zoom_xywh
    shift = np.asarray([x1, y1, x1, y1], np.float32)

    clipped = ori["boxes"] - shift
    clipped[:, 0::2] = np.clip(clipped[:, 0::2], 0, cw)
    clipped[:, 1::2] = np.clip(clipped[:, 1::2], 0, ch)
    nonempty = ((clipped[:, 2] > clipped[:, 0])
                & (clipped[:, 3] > clipped[:, 1]))
    if nonempty.sum() == 0:
        _count(stats, kept=len(ori["boxes"]), appended=len(zoom["boxes"]))
        return _cat(ori, zoom)

    inside = _take(ori, nonempty)
    inside_clipped = clipped[nonempty] + shift
    keep = _take(ori, ~nonempty)
    border_mask = np.any(inside_clipped != inside["boxes"], axis=1)

    border = _take(inside, border_mask)
    # fuse border probs with matched zoom boxes (same class only)
    iou = _iou_matrix(zoom["boxes"], inside_clipped[border_mask])
    border_fused = 0
    if iou.size:
        best = iou.argmax(0)
        matched = iou.max(0) >= match_thresh
        for j in np.nonzero(matched)[0]:
            zi = best[j]
            probs, scores = merge_probs_bayesian(
                _f32(zoom["probs"][zi][None]), _f32(border["probs"][j][None]))
            probs = probs.numpy()[0]
            if probs.argmax() == border["classes"][j]:
                border["probs"][j] = probs
                border["scores"][j] = float(scores.numpy()[0])
                border_fused += 1

    change = _take(inside, ~border_mask)
    change["boxes"] = inside_clipped[~border_mask]
    iou = _iou_matrix(zoom["boxes"], change["boxes"])
    matched_zoom = iou.argmax(0) if iou.size else np.zeros(0, int)
    confirmed = iou.max(0) >= match_thresh if iou.size else np.zeros(0,
                                                                     bool)
    dropped = (~confirmed).sum()
    change = _take(change, confirmed)
    mz = matched_zoom[confirmed]
    used_zoom = set(mz.tolist())
    same = np.zeros(0, bool)
    if len(mz):
        same = zoom["classes"][mz] == change["classes"]
        change["classes"] = zoom["classes"][mz]
        # class mismatch → zoom wins outright
        change["scores"][~same] = zoom["scores"][mz][~same]
        change["probs"][~same] = zoom["probs"][mz][~same]
        change["boxes"][~same] = zoom["boxes"][mz][~same]
        if same.any():
            fused = weighted_box_fusion_pair(
                _f32(zoom["boxes"][mz][same]), _f32(change["boxes"][same]),
                _f32(zoom["scores"][mz][same]),
                _f32(change["scores"][same])).numpy()
            change["boxes"][same] = fused
            probs, scores = merge_probs_max(_f32(zoom["probs"][mz][same]),
                                            _f32(change["probs"][same]))
            change["probs"][same] = probs.numpy()
            change["scores"][same] = scores.numpy()

    # zoom-only additions, excluding boxes hugging the crop border that
    # overlap an ORI border box
    zb = zoom["boxes"] - shift
    at_border = ((zb[:, 0] < border_px) | (zb[:, 1] < border_px)
                 | (zb[:, 2] > cw - border_px)
                 | (zb[:, 3] > ch - border_px))
    iou_b = _iou_matrix(zoom["boxes"], inside_clipped[border_mask])
    overlaps_border = (iou_b > 0.1).any(1) if iou_b.size else \
        np.zeros(len(zoom["boxes"]), bool)
    excluded = used_zoom | set(np.nonzero(at_border
                                          & overlaps_border)[0].tolist())
    add_idx = [i for i in range(len(zoom["boxes"])) if i not in excluded]
    parts = [keep, change, border]
    if add_idx:
        parts.append(_take(zoom, np.asarray(add_idx)))
    _count(stats, kept=len(keep["boxes"]), border=len(border["boxes"]),
           border_fused=border_fused, fused=same.sum(),
           replaced=(~same).sum(), dropped=dropped, appended=len(add_idx))
    return _cat(*parts)
