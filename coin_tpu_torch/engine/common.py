"""Shared engine utilities (counterpart of coin_tpu/engine/common.py):
``simple_class_tokens`` (:34-55), ``lr_value`` and ``MetricLogger``
(:65-147), and ``synthetic_detections`` for runs without a cloud store."""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from coin_tpu_torch.structures import Detections

logger = logging.getLogger(__name__)


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


def lr_value(schedule, step: int) -> float:
    """The learning rate of ``step`` for logging (the port's schedules are
    host functions already)."""
    return float(schedule(step))


class MetricLogger:
    """Console + metrics.json (+ optional TensorBoard) writer. Values may be
    device scalars (the step's losses): they are buffered as they are and
    read back only at a flush, every ``period`` steps, so the loop does not
    wait for the card at every step. With ``write`` False (a rank other
    than 0 of a process group) it records nothing."""

    def __init__(self, output_dir: str, max_iter: int, period: int = 20,
                 tensorboard: bool = False, write: bool = True):
        os.makedirs(output_dir, exist_ok=True)
        self.write = write
        self.path = os.path.join(output_dir, "metrics.json")
        self.period = period
        self.max_iter = max_iter
        self._window = defaultdict(list)
        self._t0 = time.perf_counter()
        self._last_step = None    # last flushed step (iter-time base)
        self._last_logged = None  # last step passed to log()
        self._tb = None
        if tensorboard and write:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=output_dir)
            except Exception as e:  # keep training alive without TB
                logger.warning("TensorBoard writer unavailable: %s", e)

    def _means(self) -> Dict[str, float]:
        means = {k: float(np.mean([float(v) for v in vs]))
                 for k, vs in self._window.items()}
        self._window.clear()
        return means

    def log(self, step: int, metrics: Dict[str, float]):
        if not self.write:
            return
        for k, v in metrics.items():
            self._window[k].append(v)
        self._last_logged = step
        if step % self.period != 0:
            return
        means = self._means()
        now = time.perf_counter()
        if self._last_step is not None:
            it_time = (now - self._t0) / max(step - self._last_step, 1)
            means["iter_time"] = it_time
            means["eta_min"] = it_time * (self.max_iter - step) / 60.0
        self._t0, self._last_step = now, step
        loss_str = "  ".join(f"{k}: {v:.4g}" for k, v in sorted(
            means.items()) if k.startswith("loss"))
        logger.info("iter %d  %s  it/s %.2f", step, loss_str,
                    1.0 / means["iter_time"] if means.get("iter_time")
                    else 0.0)
        with open(self.path, "a") as f:
            f.write(json.dumps({"iteration": step, **means}) + "\n")
        if self._tb is not None:
            for k, v in means.items():
                self._tb.add_scalar(k, v, step)

    def close(self):
        """Flush the residual window, stamped with the last logged step."""
        if self._window:
            step = self._last_logged if self._last_logged is not None else 0
            with open(self.path, "a") as f:
                f.write(json.dumps({"iteration": step, **self._means()})
                        + "\n")
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
