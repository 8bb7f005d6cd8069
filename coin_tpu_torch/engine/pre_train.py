"""The pre-train stage's helper that the adaptation trainer shares
(counterpart of coin_tpu/engine/pre_train.py:32). ``PRETrainer`` itself is
ROADMAP item 16."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from coin_tpu_torch.device import resolve_device
from coin_tpu_torch.structures import Detections


def online_view_to_detections(view: Dict[str, np.ndarray],
                              device="cuda") -> Detections:
    """A packed store view (``ResultStore.pack_view`` arrays, batched) →
    Detections on ``device`` (the card unless the caller passes
    ``device="cpu"``)."""
    device = resolve_device(device)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    return Detections(boxes=t(view["boxes"]), scores=t(view["scores"]),
                      classes=t(view["classes"]), valid=t(view["valid"]),
                      probs=t(view["probs"]))
