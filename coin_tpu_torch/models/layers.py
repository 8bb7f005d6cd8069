"""Layers that keep f32 master parameters and compute in a lower dtype, as
flax's ``nn.Conv(dtype=...)`` / ``nn.Dense(dtype=...)`` do with the
default ``param_dtype``: the weight, the bias and the input are cast to
``compute_dtype`` at every call (``None`` = the input's dtype). Casting an
f32 weight to bf16 once or at every call gives the same bits; keeping the
f32 master is what lets an SGD step or the EMA teacher update move it.
"""

from __future__ import annotations

from typing import Optional

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
