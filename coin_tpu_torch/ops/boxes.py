"""Box algebra: areas, pairwise IoU, delta transforms (counterpart of
coin_tpu/ops/boxes.py:19-110).

``pairwise_iou`` uses half-open widths (x2 - x1), ``pairwise_iou_plus1``
the inclusive pixel convention (x2 - x1 + 1); both return 0 where the
union is not positive.
"""

from __future__ import annotations

import math

import torch

LOG_MAX_SCALE = math.log(1000.0 / 16.0)  # detectron2 dw/dh clamp


def area(boxes: torch.Tensor, plus1: bool = False) -> torch.Tensor:
    off = 1.0 if plus1 else 0.0
    return ((boxes[..., 2] - boxes[..., 0] + off)
            * (boxes[..., 3] - boxes[..., 1] + off))


def _pairwise_iou(a: torch.Tensor, b: torch.Tensor,
                  off: float) -> torch.Tensor:
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + off).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = (area(a, off > 0)[..., :, None] + area(b, off > 0)[..., None, :]
             - inter)
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix (..., Na, Nb), half-open convention."""
    return _pairwise_iou(a, b, 0.0)


def pairwise_iou_plus1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix (..., Na, Nb), inclusive +1 pixel convention."""
    return _pairwise_iou(a, b, 1.0)


def encode_deltas(src: torch.Tensor, target: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Deltas such that decode_deltas(src, deltas) == target."""
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    scx = src[..., 0] + 0.5 * sw
    scy = src[..., 1] + 0.5 * sh
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    tcx = target[..., 0] + 0.5 * tw
    tcy = target[..., 1] + 0.5 * th
    wx, wy, ww, wh = weights
    sw = sw.clamp_min(1e-6)
    sh = sh.clamp_min(1e-6)
    return torch.stack([
        wx * (tcx - scx) / sw,
        wy * (tcy - scy) / sh,
        ww * torch.log(tw.clamp_min(1e-6) / sw),
        wh * torch.log(th.clamp_min(1e-6) / sh),
    ], dim=-1)


def decode_deltas(src: torch.Tensor, deltas: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    scx = src[..., 0] + 0.5 * sw
    scy = src[..., 1] + 0.5 * sh
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp_max(LOG_MAX_SCALE)
    dh = (deltas[..., 3] / wh).clamp_max(LOG_MAX_SCALE)
    pcx = dx * sw + scx
    pcy = dy * sh + scy
    pw = torch.exp(dw) * sw
    ph = torch.exp(dh) * sh
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)
