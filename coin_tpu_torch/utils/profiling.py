"""Tracing and timing utilities (counterpart of coin_tpu/utils/profiling.py;
SURVEY §5: the reference only has an IterationTimer hook, here a
``torch.profiler`` trace as well)."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import deque
from typing import Optional

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace_context(logdir: str):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    a card, of its kernels around a code block, written to ``logdir`` as a
    Chrome trace (``trace.json``: chrome://tracing or Perfetto). Yields
    the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("wrote the profiler's trace to %s", path)


class IterationTimer:
    """Rolling iteration/data-time tracker (replaces d2 IterationTimer +
    the data_time metric of trainer.run_step)."""

    def __init__(self, window: int = 20):
        self.iter_times = deque(maxlen=window)
        self.data_times = deque(maxlen=window)
        self._t_start: Optional[float] = None
        self._t_data: Optional[float] = None

    def before_data(self):
        self._t_data = time.perf_counter()

    def after_data(self):
        if self._t_data is not None:
            self.data_times.append(time.perf_counter() - self._t_data)
        self._t_start = time.perf_counter()

    def after_step(self):
        if self._t_start is not None:
            self.iter_times.append(time.perf_counter() - self._t_start)

    @property
    def avg_iter(self) -> float:
        return (sum(self.iter_times) / len(self.iter_times)
                if self.iter_times else 0.0)

    @property
    def avg_data(self) -> float:
        return (sum(self.data_times) / len(self.data_times)
                if self.data_times else 0.0)
