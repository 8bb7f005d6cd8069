"""CKG (Consistent Knowledge Generation) merge network (counterpart of
coin_tpu/models/ckg.py): two multi-head cross-attentions, query = region
feature, key/value = class prototypes (offline, online), each emitting
per-class weights; the fused probabilities are softmax(w_off·p_off +
w_on·p_on). f32 throughout; names follow the flax tree.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from coin_tpu_torch.models.layers import lecun_normal_


class CrossAttention(nn.Module):
    def __init__(self, hidden_size: int, num_classes: int,
                 head_num: int = 8):
        super().__init__()
        self.head_num = head_num
        self.linear_q = nn.Linear(hidden_size, hidden_size, bias=False)
        self.linear_k = nn.Linear(hidden_size, hidden_size, bias=False)
        self.linear_v = nn.Linear(hidden_size, hidden_size, bias=False)
        self.linear_output = nn.Linear(hidden_size, num_classes)

    def forward(self, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """x (N, D) region features, kv (C, D) prototypes → (N, classes)
        per-class weights."""
        d = x.shape[-1]
        hd = d // self.head_num
        q = self.linear_q(x).reshape(-1, self.head_num, hd)
        k = self.linear_k(kv).reshape(-1, self.head_num, hd)
        v = self.linear_v(kv).reshape(-1, self.head_num, hd)
        attn = torch.einsum("nhd,chd->hnc", q, k) / math.sqrt(hd)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("hnc,chd->nhd", attn, v).reshape(-1, d)
        return self.linear_output(out)


class CKGNet(nn.Module):
    def __init__(self, hidden_size: int, num_classes: int,
                 head_num: int = 8):
        """``hidden_size`` is MODEL.MERGE_DIM; ``num_classes`` counts the
        background."""
        super().__init__()
        self.cross_offline = CrossAttention(hidden_size, num_classes,
                                            head_num)
        self.cross_online = CrossAttention(hidden_size, num_classes,
                                           head_num)

    def forward(self, x, prototype_offline, prototype_online,
                probs_offline, probs_online) -> torch.Tensor:
        w_off = self.cross_offline(x, prototype_offline)
        w_on = self.cross_online(x, prototype_online)
        return torch.softmax(w_off * probs_offline + w_on * probs_online,
                             dim=-1)

    @torch.no_grad()
    def random_init(self, seed: int) -> "CKGNet":
        """flax's Dense initialisers from ``seed``, drawn on the CPU:
        LeCun-normal kernels (truncated at 2 σ), zero biases."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                lecun_normal_(p, gen)
        return self
