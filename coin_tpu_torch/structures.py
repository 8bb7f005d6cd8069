"""Padded detection sets (counterpart of coin_tpu/structures.py:34-195
``Detections``, ``concatenate``, ``truncate`` and ``compact``).

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

    @property
    def capacity(self) -> int:
        return self.boxes.shape[-2]

    def replace(self, **kw) -> "Detections":
        return dataclasses.replace(self, **kw)

    def mask(self, keep: torch.Tensor) -> "Detections":
        """AND the validity mask with ``keep`` (rows stay where they are)."""
        return self.replace(valid=self.valid & keep)

    def map(self, fn) -> "Detections":
        """``fn`` applied to every field that is present."""
        return Detections(fn(self.boxes), fn(self.scores), fn(self.classes),
                          fn(self.valid),
                          None if self.probs is None else fn(self.probs))

    def gather(self, idx: torch.Tensor,
               idx_valid: torch.Tensor) -> "Detections":
        """Rows ``idx`` (..., K) of every field along the capacity axis;
        rows where ``idx_valid`` is false become padding (class -1, not
        valid), as coin_tpu/structures.py:104 ``gather`` per set."""
        lead = idx.dim() - 1

        def take(a):
            extra = a.dim() - lead - 1
            i = idx.reshape(idx.shape + (1,) * extra)
            return torch.gather(a, lead, i.expand(idx.shape + a.shape[
                lead + 1:]))
        return Detections(
            boxes=take(self.boxes), scores=take(self.scores),
            classes=torch.where(idx_valid, take(self.classes),
                                torch.full_like(idx, -1,
                                                dtype=self.classes.dtype)),
            valid=take(self.valid) & idx_valid,
            probs=None if self.probs is None else take(self.probs))


def concatenate(a: Detections, b: Detections) -> Detections:
    """Concatenate two padded sets along the capacity axis; ``probs`` only
    when both carry them."""
    probs = None
    if a.probs is not None and b.probs is not None:
        probs = torch.cat([a.probs, b.probs], dim=-2)
    return Detections(
        boxes=torch.cat([a.boxes, b.boxes], dim=-2),
        scores=torch.cat([a.scores, b.scores], dim=-1),
        classes=torch.cat([a.classes, b.classes], dim=-1),
        valid=torch.cat([a.valid, b.valid], dim=-1),
        probs=probs,
    )


def compact(d: Detections) -> Detections:
    """Move valid rows to the front, stably, padding to the back (a batched
    set; padding rows keep their fields)."""
    order = torch.sort((~d.valid).to(torch.uint8), dim=-1,
                       stable=True).indices

    def take(a):
        idx = order.reshape(order.shape + (1,) * (a.dim() - order.dim()))
        return torch.gather(a, order.dim() - 1,
                            idx.expand(order.shape + a.shape[order.dim():]))
    return d.map(take)


def truncate(d: Detections, capacity: int) -> Detections:
    """Compact valid rows to the front and keep the first ``capacity``
    slots."""
    c = compact(d)
    return Detections(
        boxes=c.boxes[..., :capacity, :],
        scores=c.scores[..., :capacity],
        classes=c.classes[..., :capacity],
        valid=c.valid[..., :capacity],
        probs=None if c.probs is None else c.probs[..., :capacity, :],
    )
