"""Train state of the adaptation step (counterpart of
coin_tpu/engine/state.py).

The JAX package threads one functional pytree through a jitted step. Here
the state is a set of modules and optimizers updated in place:
- ``model``: the student; its frozen leaves (``default_freeze_predicate``)
  have ``requires_grad`` False, so autograd builds no weight gradient for
  them (the gradient still flows through them to earlier layers);
- ``teacher``: the EMA teacher, a copy of the student whose trainable
  parameters follow the EMA and whose frozen leaves equal the student's;
- ``merge_model`` and the two optimizers, the prototypes, the step count
  and the generator of the step's random draws.
The pre-train step's state has no teacher, CKG net or merge optimizer
(None), as the JAX ``PRETrainer``'s ``TrainState`` has none; the oracle's
has no prototypes either, as the JAX ``OracleTrainer``'s.
Buffer donation (``jit_train_step``) has no counterpart: updates are in
place.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from coin_tpu_torch.parallel import mesh_utils
from coin_tpu_torch.solver.build import ScheduledSGD


def default_freeze_predicate(update_backbone: bool = True,
                             freeze_at: int = 2) -> Callable[[str], bool]:
    """The reference's freeze policy on a parameter name (dotted or
    '/'-joined): the text trunk always; every FrozenBN leaf; the stem and
    the first ``freeze_at - 1`` stages (detectron2 FREEZE_AT, default 2:
    stem and layer1); with ``update_backbone`` False, the whole backbone
    outside layer4."""

    def pred(name: str) -> bool:
        p = name.replace(".", "/").lower()
        if "text_trunk" in p:
            return True
        if "/bn" in p or p.startswith("bn") or "downsample_bn" in p:
            return True
        if "backbone/" in p:
            if freeze_at >= 1 and "layer" not in p:
                return True
            for idx, stage in enumerate(("layer1/", "layer2/", "layer3/"),
                                        start=2):
                if freeze_at >= idx and stage in p:
                    return True
            if not update_backbone and "layer4" not in p:
                return True
        return False

    return pred


def freeze(model: nn.Module, is_frozen: Callable[[str], bool]) -> nn.Module:
    """Turn off ``requires_grad`` of the parameters ``is_frozen`` names."""
    for name, p in model.named_parameters():
        p.requires_grad_(not is_frozen(name))
    return model


def trainable(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """The trainable (name, parameter) pairs, in registration order."""
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def make_teacher(model: nn.Module) -> nn.Module:
    """The EMA teacher at its start: a copy of the student, without
    gradients."""
    teacher = copy.deepcopy(model)
    teacher.requires_grad_(False)
    return teacher


@torch.no_grad()
def ema_update_(teacher: nn.Module, student: nn.Module,
                keep_rate: float) -> None:
    """t ← t·k + s·(1 − k) over the student's trainable parameters, in
    place and in f32."""
    t_params = dict(teacher.named_parameters())
    names = [n for n, _ in trainable(student)]
    t = [t_params[n] for n in names]
    s = [p for _, p in trainable(student)]
    torch._foreach_mul_(t, keep_rate)
    torch._foreach_add_(t, s, alpha=1.0 - keep_rate)


@dataclasses.dataclass
class Prototypes:
    """Evolving class prototypes, (C+1, D) each."""
    proto: torch.Tensor
    b_online: torch.Tensor
    b_offline: torch.Tensor


def prototype_ema(current: torch.Tensor, feats: torch.Tensor,
                  one_hot: torch.Tensor, valid: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """Classes present among the valid rows move toward their batch mean
    of (normalised) features; absent classes keep their value. In a
    data-parallel step the counts and sums are the global batch's."""
    oh = torch.where(valid[:, None], one_hot, torch.zeros_like(one_hot))
    counts, sums = mesh_utils.global_sum(oh.sum(0), oh.T @ feats.float())
    mean = sums / counts.clamp_min(1.0)[:, None]
    new = torch.where((counts > 0)[:, None], mean, current)
    return current * rate + (1.0 - rate) * new


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    teacher: Optional[nn.Module]
    merge_model: Optional[nn.Module]
    optimizer: ScheduledSGD
    merge_optimizer: Optional[ScheduledSGD]
    prototypes: Optional[Prototypes]
    step: int
    generator: torch.Generator
