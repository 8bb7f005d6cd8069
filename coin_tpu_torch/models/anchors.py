"""Copy of coin_tpu/models/anchors.py (numpy-only).

Anchor generation (detectron2 DefaultAnchorGenerator semantics, C4:
single feature level, stride 16, sizes 32..512 × ratios 0.5/1/2)."""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np


@lru_cache(maxsize=32)
def cell_anchors(sizes: Tuple[float, ...] = (32, 64, 128, 256, 512),
                 ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)) -> np.ndarray:
    """(A, 4) xyxy anchors centered at (0, 0)."""
    out = []
    for size in sizes:
        area = float(size) ** 2
        for r in ratios:
            w = np.sqrt(area / r)
            h = w * r
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, np.float32)


@lru_cache(maxsize=32)
def grid_anchors(feat_h: int, feat_w: int, stride: int = 16,
                 sizes: Tuple[float, ...] = (32, 64, 128, 256, 512),
                 ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)) -> np.ndarray:
    """All anchors for a feature grid, shape (H*W*A, 4), ordered
    row-major-then-anchor (matches the (N, Hi, Wi, A) flatten used by the
    reference RPN, coin/modeling/proposal_generator/rpn.py:67-71)."""
    base = cell_anchors(sizes, ratios)  # (A, 4)
    shift_x = np.arange(feat_w, dtype=np.float32) * stride
    sy, sx = np.meshgrid(np.arange(feat_h, dtype=np.float32) * stride,
                         shift_x, indexing="ij")
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    anchors = shifts + base[None]
    return anchors.reshape(-1, 4)
