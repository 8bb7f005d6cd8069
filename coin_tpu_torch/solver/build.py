"""Optimizer and LR schedule (counterpart of coin_tpu/solver/build.py).

The JAX package builds an optax chain: (``SOLVER.CLIP_GRADIENTS``: the
global-norm clip) → weight decay → momentum trace → −lr(count) → a
per-parameter multiplier.
:class:`ScheduledSGD` is the same update as ``torch.optim.SGD`` with one
parameter group per multiplier: the clip scales the raw gradients of every
parameter it holds, multiplier 0 included, then SGD adds
``weight_decay · p`` to the gradient, keeps the momentum buffer and steps
by the group's lr, which is set to ``schedule(count) · multiplier`` before
each step. A multiplier of 0 still moves the momentum. ``count`` is the
optimizer's own update count, as optax counts from ``tx.init``, not the
train step. Schedules compute in float32, as the JAX schedule does.
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


def warmup_cosine_lr_schedule(base_lr: float, max_iter: int,
                              warmup_iters: int, warmup_factor: float
                              ) -> Callable[[int], float]:
    """optax's ``linear_schedule(base · warmup_factor → base over
    warmup_iters)`` joined at ``warmup_iters`` with
    ``cosine_decay_schedule(base, max(max_iter − warmup_iters, 1))``, in
    float32 and in optax's operations (not detectron2's multiplicative
    warmup); the cosine of the f32 angle is taken in f64 and rounded. The
    compiled JAX schedule may differ by a few ulp: XLA folds π / decay
    into one constant, and its f32 cosine is its own."""
    init, end = base_lr * warmup_factor, base_lr
    decay = float(max(max_iter - warmup_iters, 1))

    def schedule(step: int) -> float:
        if step < warmup_iters:
            count = f32(max(step, 0))
            frac = f32(1) - count / f32(warmup_iters)
            return float(f32(init - end) * frac + f32(end))
        count = f32(min(step - warmup_iters, decay))
        angle = f32(np.pi) * count / f32(decay)
        cosine = f32(0.5) * (f32(1) + f32(np.cos(np.float64(angle))))
        return float(f32(base_lr) * cosine)

    return schedule


def make_schedule(sol) -> Callable[[int], float]:
    """``SOLVER.LR_SCHEDULER_NAME``: WarmupTwoStageMultiStepLR (every
    shipped config), WarmupMultiStepLR (factors ``GAMMA ** i``) or
    WarmupCosineLR."""
    name = sol.get("LR_SCHEDULER_NAME", "WarmupTwoStageMultiStepLR")
    if name == "WarmupTwoStageMultiStepLR":
        return two_stage_lr_schedule(sol.BASE_LR, sol.STEPS,
                                     sol.FACTOR_LIST, sol.WARMUP_ITERS,
                                     sol.WARMUP_FACTOR)
    if name == "WarmupMultiStepLR":
        gamma = sol.get("GAMMA", 0.1)
        return two_stage_lr_schedule(
            sol.BASE_LR, sol.STEPS,
            [gamma ** i for i in range(len(sol.STEPS) + 1)],
            sol.WARMUP_ITERS, sol.WARMUP_FACTOR)
    if name == "WarmupCosineLR":
        return warmup_cosine_lr_schedule(sol.BASE_LR, sol.MAX_ITER,
                                         sol.WARMUP_ITERS, sol.WARMUP_FACTOR)
    raise ValueError(f"unknown scheduler: {name}")


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
    ``coin_tpu.solver.build_optimizer``), the gradients first clipped to
    the global norm ``clip_norm`` when it is given."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 schedule: Callable[[int], float],
                 multipliers: Dict[str, float], momentum: float,
                 weight_decay: float, nesterov: bool = False,
                 clip_norm: Optional[float] = None):
        self.schedule = schedule
        self.clip_norm = clip_norm
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
        if self.clip_norm is not None:
            self._clip_by_global_norm()
        lr = self.schedule(self.count)
        for g in self.sgd.param_groups:
            g["lr"] = lr * g["mult"]
        self.sgd.step()
        self.count += 1

    def _clip_by_global_norm(self) -> None:
        """optax's ``clip_by_global_norm``: every gradient becomes
        ``(g / norm) · clip_norm`` when the norm over all of them reaches
        ``clip_norm``, on the device and without a host sync."""
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        clip = norm >= self.clip_norm
        div = torch.where(clip, norm, torch.ones_like(norm))
        mul = torch.where(clip, torch.full_like(norm, self.clip_norm),
                          torch.ones_like(norm))
        for g in grads:
            g.div_(div).mul_(mul)

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
    (``PER_MODULE_PARAM_WEIGHT[0]`` unless ``overrides`` is given), the
    gradients clipped to ``CLIP_GRADIENTS.CLIP_VALUE`` when
    ``CLIP_GRADIENTS.ENABLED``. The JAX package's named groups other than
    'all' have no caller in either package and are not ported."""
    sol = cfg.SOLVER
    clip = (float(sol.CLIP_GRADIENTS.CLIP_VALUE)
            if sol.CLIP_GRADIENTS.ENABLED else None)
    if overrides is None:
        overrides = (sol.PER_MODULE_PARAM_WEIGHT[0]
                     if sol.PER_MODULE_PARAM_WEIGHT else {})
    named_params = list(named_params)
    mults = {n: lr_multiplier_for_path(n, overrides)
             for n, _ in named_params}
    return ScheduledSGD(named_params, make_schedule(sol), mults,
                        sol.MOMENTUM, sol.WEIGHT_DECAY, bool(sol.NESTEROV),
                        clip_norm=clip)
