"""Optimizer and LR schedule (counterpart of coin_tpu/solver/build.py).

The JAX package builds an optax chain: weight decay → momentum trace →
−lr(count) → a per-parameter multiplier.
:class:`ScheduledSGD` is the same update as ``torch.optim.SGD`` with one
parameter group per multiplier: SGD adds ``weight_decay · p`` to the
gradient, then keeps the momentum buffer, then steps by the group's lr,
which is set to ``schedule(count) · multiplier`` before each step. A
multiplier of 0 still moves the momentum. ``count`` is the optimizer's own
update count, as optax counts from ``tx.init``, not the train step.
Schedules compute in float32, as the JAX schedule does.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

f32 = np.float32


def two_stage_lr_schedule(base_lr: float, milestones, factor_list,
                          warmup_iters: int = 1000,
                          warmup_factor: float = 0.001
                          ) -> Callable[[int], float]:
    """lr = base · warmup(t) · factor_list[#milestones ≤ t] (detectron2's
    linear warmup)."""
    assert len(factor_list) == len(milestones) + 1
    milestones = [int(m) for m in milestones]

    def schedule(step: int) -> float:
        s = f32(step)
        alpha = s / f32(max(warmup_iters, 1))
        warm = f32(1.0) if s >= warmup_iters else \
            f32(warmup_factor) * (f32(1.0) - alpha) + alpha
        idx = sum(s >= m for m in milestones)
        return float(f32(base_lr) * warm * f32(factor_list[idx]))

    return schedule


def make_schedule(sol) -> Callable[[int], float]:
    """The schedule every shipped config uses; the JAX package's other
    two (WarmupMultiStepLR, WarmupCosineLR) are not ported."""
    name = sol.get("LR_SCHEDULER_NAME", "WarmupTwoStageMultiStepLR")
    if name != "WarmupTwoStageMultiStepLR":
        raise NotImplementedError(f"LR_SCHEDULER_NAME {name} is not ported")
    return two_stage_lr_schedule(sol.BASE_LR, sol.STEPS, sol.FACTOR_LIST,
                                 sol.WARMUP_ITERS, sol.WARMUP_FACTOR)


def lr_multiplier_for_path(path: str, overrides: Dict[str, float]) -> float:
    """Every key that is a substring of the parameter name overwrites the
    multiplier, in dict order (later keys win)."""
    mult = 1.0
    for key, value in overrides.items():
        if key in path:
            mult = float(value)
    return mult


class ScheduledSGD:
    """SGD with momentum, weight decay, a schedule over its own update
    count and per-parameter LR multipliers (the optax chain of
    ``coin_tpu.solver.build_optimizer``)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 schedule: Callable[[int], float],
                 multipliers: Dict[str, float], momentum: float,
                 weight_decay: float, nesterov: bool = False):
        self.schedule = schedule
        self.names: List[str] = []
        self.params: List[torch.Tensor] = []
        groups: Dict[float, List[torch.Tensor]] = {}
        for name, p in named_params:
            self.names.append(name)
            self.params.append(p)
            groups.setdefault(multipliers[name], []).append(p)
        self.multipliers = dict(multipliers)
        self.sgd = torch.optim.SGD(
            [{"params": ps, "mult": m} for m, ps in groups.items()],
            lr=0.0, momentum=momentum, weight_decay=weight_decay,
            nesterov=nesterov)
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad``; a parameter without
        a gradient is updated with a zero one (decay and momentum still
        apply, as in optax)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        lr = self.schedule(self.count)
        for g in self.sgd.param_groups:
            g["lr"] = lr * g["mult"]
        self.sgd.step()
        self.count += 1

    def momentum_buffers(self) -> Dict[str, Optional[torch.Tensor]]:
        return {n: self.sgd.state.get(p, {}).get("momentum_buffer")
                for n, p in zip(self.names, self.params)}

    def set_momentum_buffers(self, buffers: Dict[str, torch.Tensor]) -> None:
        for n, p in zip(self.names, self.params):
            if n in buffers:
                self.sgd.state[p]["momentum_buffer"] = \
                    buffers[n].to(p.device, p.dtype).clone()


def build_optimizer(named_params, cfg,
                    overrides: Optional[Dict] = None) -> ScheduledSGD:
    """SGD + schedule + per-name multipliers from ``cfg.SOLVER``
    (``PER_MODULE_PARAM_WEIGHT[0]`` unless ``overrides`` is given). The
    JAX package's named groups other than 'all' serve the pre-train slice
    and are not ported; no shipped config clips gradients."""
    sol = cfg.SOLVER
    if sol.CLIP_GRADIENTS.ENABLED:
        raise NotImplementedError("SOLVER.CLIP_GRADIENTS is not ported")
    if overrides is None:
        overrides = (sol.PER_MODULE_PARAM_WEIGHT[0]
                     if sol.PER_MODULE_PARAM_WEIGHT else {})
    named_params = list(named_params)
    mults = {n: lr_multiplier_for_path(n, overrides)
             for n, _ in named_params}
    return ScheduledSGD(named_params, make_schedule(sol), mults,
                        sol.MOMENTUM, sol.WEIGHT_DECAY, bool(sol.NESTEROV))
