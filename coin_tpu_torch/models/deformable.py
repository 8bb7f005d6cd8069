"""Multi-scale deformable attention (counterpart of
coin_tpu/models/deformable.py).

``ms_deform_sample`` is kernel K7 on a CUDA tensor (csrc/ms_deform.cu,
launched by kernels/ms_deform.py) and :func:`ms_deform_sample_plain` on a
CPU tensor. ``MSDeformAttention`` takes 2-d reference points (the
encoder's grid) or 4-d reference boxes (the decoder's), as
deformable.py:102-112 does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from coin_tpu_torch.models.layers import Linear, cached_constant


def _level_tensors(spatial_shapes, level_starts, device):
    """(L, 2) int32 shapes (h, w), (L,) int32 starts and (L, 2) f32 (w, h)
    on ``device``, built once per geometry."""
    key = (tuple(map(tuple, spatial_shapes)), tuple(level_starts))
    return (cached_constant(("shapes",) + key, lambda: np.asarray(
                spatial_shapes, np.int32), device),
            cached_constant(("starts",) + key, lambda: np.asarray(
                level_starts, np.int32), device),
            cached_constant(("wh",) + key, lambda: np.asarray(
                [[w, h] for (h, w) in spatial_shapes], np.float32), device))


def ms_deform_sample_plain(values: torch.Tensor,
                           spatial_shapes: Sequence[Tuple[int, int]],
                           level_starts: Sequence[int],
                           locations: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """Plain version of K7, in deformable.py:20-62's order, rounding every
    tap and sum to the values' dtype as JAX does. values (B, ΣHW, H, D);
    locations (B, Q, H, L, P, 2) normalised (x, y); weights
    (B, Q, H, L, P) → (B, Q, H, D)."""
    b, _, heads, d = values.shape
    _, q, _, _, p, _ = locations.shape
    out = torch.zeros((b, q, heads, d), dtype=values.dtype,
                      device=values.device)
    values_h_first = values.permute(0, 2, 1, 3)          # (B, H, ΣHW, D)
    for lvl, (h, w) in enumerate(spatial_shapes):
        start = level_starts[lvl]
        loc = locations[:, :, :, lvl]                    # (B, Q, H, P, 2)
        x = loc[..., 0] * w - 0.5
        y = loc[..., 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0

        def tap(yy, xx, wgt):
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            yy = yy.clamp(0, h - 1).long()
            xx = xx.clamp(0, w - 1).long()
            flat = start + yy * w + xx                   # (B, Q, H, P)
            idx = flat.permute(0, 2, 1, 3).reshape(b, heads, q * p, 1)
            v = torch.gather(values_h_first, 2, idx.expand(-1, -1, -1, d))
            v = v.reshape(b, heads, q, p, d).permute(0, 2, 1, 3, 4)
            w_in = torch.where(inside, wgt, torch.zeros_like(wgt))
            return v * w_in[..., None].to(v.dtype)

        acc = (tap(y0, x0, (1 - fy) * (1 - fx))
               + tap(y0, x0 + 1, (1 - fy) * fx)
               + tap(y0 + 1, x0, fy * (1 - fx))
               + tap(y0 + 1, x0 + 1, fy * fx))
        lvl_w = weights[:, :, :, lvl]                    # (B, Q, H, P)
        out = out + (acc * lvl_w[..., None].to(acc.dtype)).sum(dim=3)
    return out


def ms_deform_sample(values: torch.Tensor,
                     spatial_shapes: Sequence[Tuple[int, int]],
                     level_starts: Sequence[int], locations: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """K7 on a CUDA tensor, its plain version on a CPU one."""
    if values.is_cuda:
        from coin_tpu_torch.kernels.ms_deform import ms_deform_cuda
        shapes, starts, _ = _level_tensors(spatial_shapes, level_starts,
                                           values.device)
        return ms_deform_cuda(values, shapes, starts, locations, weights)
    return ms_deform_sample_plain(values, spatial_shapes, level_starts,
                                  locations, weights)


class MSDeformAttention(nn.Module):
    """Deformable attention: each query samples the multi-level values at
    learned offsets around its reference."""

    def __init__(self, dim: int = 256, heads: int = 8, levels: int = 4,
                 points: int = 4):
        super().__init__()
        self.dim, self.heads, self.levels, self.points = \
            dim, heads, levels, points
        self.value_proj = Linear(dim, dim)
        self.sampling_offsets = Linear(dim, heads * levels * points * 2)
        self.attention_weights = Linear(dim, heads * levels * points)
        self.output_proj = Linear(dim, dim)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                value: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]],
                level_starts: Sequence[int],
                value_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (B, Q, C); reference_points (B, Q, L, 2) or (B, Q, L, 4)
        normalised; value (B, ΣHW, C)."""
        b, q, _ = query.shape
        nh, nl, np_ = self.heads, self.levels, self.points
        v = self.value_proj(value)
        if value_mask is not None:
            v = torch.where(value_mask[..., None], v, torch.zeros_like(v))
        v = v.reshape(b, -1, nh, self.dim // nh)
        offsets = self.sampling_offsets(query).reshape(b, q, nh, nl, np_, 2)
        attn = self.attention_weights(query).reshape(b, q, nh, nl * np_)
        attn = torch.softmax(attn.float(), dim=-1).reshape(b, q, nh, nl, np_)
        if reference_points.shape[-1] == 2:
            shapes_wh = _level_tensors(spatial_shapes, level_starts,
                                       query.device)[2]
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets.float() / shapes_wh[None, None, None, :, None])
        else:
            center = reference_points[..., :2]
            wh = reference_points[..., 2:]
            loc = (center[:, :, None, :, None, :]
                   + offsets.float() / np_ * wh[:, :, None, :, None, :]
                   * 0.5)
        sampled = ms_deform_sample(v, spatial_shapes, level_starts, loc, attn)
        return self.output_proj(sampled.reshape(b, q, self.dim))
