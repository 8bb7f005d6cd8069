"""Swin Transformer backbone of the Grounding DINO cloud teacher
(counterpart of coin_tpu/models/swin.py).

Tokens stay channels-last, (B, H·W, C), as in the JAX package, and each
stage pads H and W to multiples of the window once (swin.py:179-197), not
per block as the official Swin does; the padded tokens go through the
blocks unmasked, as in JAX. Module names follow the flax tree
(``layers_{stage}_blocks_{block}``, ``attn.qkv`` ...), so
``convert_from_jax.from_jax_variables`` and ``models/convert_gdino``
fill them.

The window attention's core is kernel K9 on a CUDA tensor
(csrc/window_attention.cu, launched by kernels/window_attention.py) and
:func:`window_attention_plain` on a CPU tensor. The ``qkv``, ``proj`` and
MLP linears are ``torch.matmul`` through ``layers.Linear``, which casts
the f32 master to the compute dtype. LayerNorms are flax's: ε = 1e-6,
computed in f32, cast back.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coin_tpu_torch.models.layers import (Conv2d, LayerNorm32, Linear,
                                          cached_constant, conv_nhwc)

SWIN_CFGS = {
    "swinT": dict(embed_dim=96, depths=(2, 2, 6, 2),
                  num_heads=(3, 6, 12, 24), window=7),
    "swinB": dict(embed_dim=128, depths=(2, 2, 18, 2),
                  num_heads=(4, 8, 16, 32), window=12),
    "swinL": dict(embed_dim=192, depths=(2, 2, 18, 2),
                  num_heads=(6, 12, 24, 48), window=12),
}


def _rel_pos_index(window: int) -> np.ndarray:
    """(w², w²) index into the (2w−1)² relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]       # (2, w², w²)
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int32)


def _attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Cross-window mask for shifted windows: (nW, w², w²) with -1e9 where
    two tokens come from different original windows."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    slices = [slice(0, -window), slice(-window, -shift),
              slice(-shift, None)]
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, :, None] != win[:, None, :]
    return np.where(diff, -1e9, 0.0).astype(np.float32)


def window_attention_plain(qkv: torch.Tensor, table: torch.Tensor,
                           index: torch.Tensor,
                           mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain version of K9, in swin.py:69-90's order. qkv (B·nW, n, 3, h,
    d); table ((2w-1)², h) f32; index (n, n) int32; mask (nW, n, n) f32 or
    None → (B·nW, n, h·d) in qkv's dtype."""
    bn, n, _, heads, hd = qkv.shape
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    attn = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    attn = attn / torch.tensor(float(np.sqrt(hd)), dtype=torch.float32,
                               device=qkv.device)
    bias = table[index.reshape(-1).long()].reshape(n, n, heads)
    attn = attn + bias.permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(bn // nw, nw, heads, n, n)
                + mask[None, :, None]).reshape(bn, heads, n, n)
    attn = torch.softmax(attn, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", attn.float(), v.float())
    return out.to(qkv.dtype).reshape(bn, n, heads * hd)


def window_attention(qkv: torch.Tensor, table: torch.Tensor,
                     index: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """K9 on a CUDA tensor, its plain version on a CPU one."""
    if qkv.is_cuda:
        from coin_tpu_torch.kernels.window_attention import \
            window_attention_cuda
        return window_attention_cuda(qkv, table, index, mask)
    return window_attention_plain(qkv, table, index, mask)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.dim, self.heads, self.window = dim, heads, window
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bn, n, _ = x.shape
        qkv = self.qkv(x).reshape(bn, n, 3, self.heads, self.dim // self.heads)
        index = cached_constant(("index", self.window),
                                lambda: _rel_pos_index(self.window),
                                x.device)
        out = window_attention(qkv, self.relative_position_bias_table,
                               index, mask)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm32(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = LayerNorm32(dim)
        self.mlp_fc1 = Linear(dim, dim * 4)
        self.mlp_fc2 = Linear(dim * 4, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        # x: (B, H·W, C); H, W already padded to multiples of the window
        b, l, c = x.shape
        win, s = self.window, self.shift
        shortcut = x
        x = self.norm1(x).to(x.dtype).reshape(b, h, w, c)
        mask = None
        if s:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
            mask = cached_constant(("mask", h, w, win, s),
                                   lambda: _attn_mask(h, w, win, s),
                                   x.device)
        xw = x.reshape(b, h // win, win, w // win, win, c)
        xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)
        xw = self.attn(xw, mask)
        x = xw.reshape(b, h // win, w // win, win, win, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
        if s:
            x = torch.roll(x, (s, s), dims=(1, 2))
        x = shortcut + x.reshape(b, l, c)
        y = self.norm2(x).to(x.dtype)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(y), approximate="none"))
        return x + y


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm32(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        if h % 2 or w % 2:                   # the official Swin pads odd dims
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = x.reshape(b, ((h + 1) // 2) * ((w + 1) // 2), 4 * c)
        return self.reduction(self.norm(x).to(x.dtype))


class SwinTransformer(nn.Module):
    """Features of stages 1..3 (strides 8/16/32), channels-last
    (B, H, W, C): the levels GDINO consumes (out_indices=(1, 2, 3))."""

    def __init__(self, variant: str = "swinB",
                 out_indices: Tuple[int, ...] = (1, 2, 3)):
        super().__init__()
        cfg = SWIN_CFGS[variant]
        self.cfg, self.out_indices = cfg, tuple(out_indices)
        dim = cfg["embed_dim"]
        self.patch_embed_proj = Conv2d(3, dim, 4, stride=4)
        self.patch_embed_norm = LayerNorm32(dim)
        for stage, depth in enumerate(cfg["depths"]):
            sdim = dim * 2 ** stage
            for blk in range(depth):
                shift = 0 if blk % 2 == 0 else cfg["window"] // 2
                self.add_module(f"layers_{stage}_blocks_{blk}", SwinBlock(
                    sdim, cfg["num_heads"][stage], cfg["window"], shift))
            if stage in self.out_indices:
                self.add_module(f"out_norm_{stage}", LayerNorm32(sdim))
            if stage < len(cfg["depths"]) - 1:
                self.add_module(f"layers_{stage}_downsample",
                                PatchMerging(sdim))

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        cfg = self.cfg
        win = cfg["window"]
        b, ih, iw, _ = images.shape
        if ih % 4 or iw % 4:
            raise ValueError(f"SwinTransformer: {ih} x {iw} is not a "
                             "multiple of 4")
        x = conv_nhwc(self.patch_embed_proj, images)
        h, w, dim = x.shape[1], x.shape[2], x.shape[3]
        x = x.reshape(b, h * w, dim)
        x = self.patch_embed_norm(x).to(x.dtype)
        outs = []
        for stage, depth in enumerate(cfg["depths"]):
            sdim = dim * 2 ** stage
            ph, pw = (-h) % win, (-w) % win
            hp, wp = h + ph, w + pw
            if ph or pw:
                x = F.pad(x.reshape(b, h, w, sdim), (0, 0, 0, pw, 0, ph))
                x = x.reshape(b, hp * wp, sdim)
            for blk in range(depth):
                x = getattr(self, f"layers_{stage}_blocks_{blk}")(x, hp, wp)
            if ph or pw:
                x = x.reshape(b, hp, wp, sdim)[:, :h, :w].reshape(
                    b, h * w, sdim)
            if stage in self.out_indices:
                out = getattr(self, f"out_norm_{stage}")(x)
                outs.append(out.reshape(b, h, w, sdim).to(x.dtype))
            if stage < len(cfg["depths"]) - 1:
                x = getattr(self, f"layers_{stage}_downsample")(x, h, w)
                h, w = (h + 1) // 2, (w + 1) // 2
        return outs
