"""Layers that keep f32 master parameters and compute in a lower dtype, as
flax's ``nn.Conv(dtype=...)`` / ``nn.Dense(dtype=...)`` do with the
default ``param_dtype``: the weight, the bias and the input are cast to
``compute_dtype`` at every call (``None`` = the input's dtype). Casting an
f32 weight to bf16 once or at every call gives the same bits; keeping the
f32 master is what lets an SGD step or the EMA teacher update move it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(dtype)
        return self._conv_forward(x.to(dtype), self.weight.to(dtype), bias)


class Linear(nn.Linear):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class LayerNorm32(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=jnp.float32)``: ε = 1e-6, computed and
    returned in f32 whatever the input's dtype (callers cast back)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class GroupNorm32(nn.Module):
    """flax ``nn.GroupNorm(num_groups, dtype=jnp.float32)`` over a
    channels-last (B, H, W, C) tensor: ε = 1e-6, flax's statistics
    (var = E[x²] - E[x]², clipped at 0), computed and returned in f32."""

    def __init__(self, groups: int, dim: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        g = x.float().reshape(b, -1, self.groups, c // self.groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = ((g * g).mean(dim=(1, 3), keepdim=True)
               - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(
            self.groups, -1)
        y = (g - mean) * mul + self.bias.reshape(self.groups, -1)
        return y.reshape(x.shape)


def truncated_normal(shape, gen: torch.Generator) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], drawn as
    ``jax.random.truncated_normal`` draws it: a uniform between erf(-2/√2)
    and erf(2/√2) through √2 erfinv, clipped inside the bounds."""
    a, b = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    x = torch.rand(shape, generator=gen).mul_(b - a).add_(a)
    lim = float(np.nextafter(np.float32(2.0), np.float32(0.0)))
    return x.erfinv_().mul_(math.sqrt(2.0)).clamp_(-lim, lim)


@torch.no_grad()
def lecun_normal_(p: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal`` (``variance_scaling(1, "fan_in",
    "truncated_normal")``) into ``p`` of layout (out, in, ...): a normal
    truncated at 2 σ, scaled so that its deviation is fan_in ** -0.5."""
    std = p[0].numel() ** -0.5 / 0.87962566103423978
    return p.copy_(truncated_normal(p.shape, gen).mul_(std))


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Every ``Conv2d`` and ``Linear`` under ``module`` computes in
    ``dtype`` (flax's ``dtype=`` on each ``nn.Conv`` / ``nn.Dense``)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.compute_dtype = dtype


_CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def cached_constant(key: Tuple, make, device) -> torch.Tensor:
    """A constant tensor (an index, a mask, a position table) that
    ``make()`` builds in numpy, made once per key and device."""
    full = key + (str(device),)
    t = _CONSTANTS.get(full)
    if t is None:
        t = _CONSTANTS[full] = torch.from_numpy(
            np.ascontiguousarray(make())).to(device)
    return t


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A channels-last (B, H, W, C) tensor through an NCHW conv module."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
