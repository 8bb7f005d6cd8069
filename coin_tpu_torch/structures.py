"""Padded detection sets (counterpart of coin_tpu/structures.py:34
``Detections``).

A ``Detections`` of capacity N carries N rows in every field; rows with
``valid == False`` are padding. Boxes are xyxy float32; ``classes`` are
0-based with -1 for padding; ``probs`` (N, C+1) includes the background
column. Fields may carry leading batch dims.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Detections:
    boxes: torch.Tensor                    # (..., N, 4) float32
    scores: torch.Tensor                   # (..., N) float32
    classes: torch.Tensor                  # (..., N) int32, -1 = padding
    valid: torch.Tensor                    # (..., N) bool
    probs: Optional[torch.Tensor] = None   # (..., N, C+1) float32
