"""Synthetic inputs for runs without CLIP assets or a cloud store: a copy
of ``simple_class_tokens`` (coin_tpu/engine/common.py:34-55) and
``synthetic_detections``."""

from __future__ import annotations

import numpy as np
import torch

from coin_tpu_torch.structures import Detections


def simple_class_tokens(num_classes_with_bg: int, context_length: int = 77,
                        prompt_tmp_len: int = 4,
                        add_prompt_num: int = 4) -> np.ndarray:
    """Synthetic per-class token table for runs without real CLIP weights:
    layout matches the learnable-prompt template
    [SOS][tmpl×4][X×4][cls][EOT][pad...] so the prompted path exercises the
    same slicing as with real CLIP tokens."""
    c = num_classes_with_bg
    toks = np.zeros((c, context_length), np.int32)
    sot, eot = 400, 500
    toks[:, 0] = sot
    for i in range(c):
        pos = 1
        for t in range(prompt_tmp_len):
            toks[i, pos] = 10 + t
            pos += 1
        for t in range(add_prompt_num):
            toks[i, pos] = 30 + t
            pos += 1
        toks[i, pos] = 100 + i
        toks[i, pos + 1] = eot
    return toks


def synthetic_detections(generator: torch.Generator, batch: int, cap: int,
                         num_classes: int, hw, n_valid) -> Detections:
    """Cloud-detector-like boxes for runs without a collection store, in
    the shape of ``__graft_entry__.dryrun_multichip``'s: random boxes in
    an (h, w) canvas, one class each with prob 0.8 (0.05 elsewhere,
    renormalised), the first ``n_valid[i]`` rows of image i valid. Drawn
    on the CPU from ``generator``."""
    h, w = hw
    xy = torch.rand((batch, cap, 2), generator=generator) \
        * torch.tensor([w, h], dtype=torch.float32)
    wh = 16.0 + torch.rand((batch, cap, 2), generator=generator) * 284.0
    boxes = torch.cat([xy, xy + wh], -1)
    boxes[..., 0::2] = boxes[..., 0::2].clamp(0, w)
    boxes[..., 1::2] = boxes[..., 1::2].clamp(0, h)
    classes = torch.randint(0, num_classes, (batch, cap), generator=generator)
    probs = torch.full((batch, cap, num_classes + 1), 0.05)
    probs.scatter_(2, classes[..., None], 0.8)
    probs = probs / probs.sum(-1, keepdim=True)
    valid = torch.arange(cap)[None] < torch.tensor(n_valid)[:, None]
    return Detections(boxes=boxes, scores=probs[..., :-1].amax(-1),
                      classes=torch.where(valid, classes, -1).int(),
                      valid=valid, probs=probs)
