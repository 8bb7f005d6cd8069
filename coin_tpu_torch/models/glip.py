"""GLIP cloud teacher (counterpart of coin_tpu/models/glip.py): Swin → FPN
with RetinaNet P6/P7 → N VLDyHead blocks → a head whose classification is
the dot product of each anchor's feature with the BERT tokens.

Each ``VLDyHeadBlock`` runs VLFuse (bidirectional image↔text attention over
the concatenated levels, embed 2048), a BERT encoder layer on the language
side, and DyConv: one shared offset-and-mask field per level, three
modulated deformable 3×3 convs with GroupNorm(16) (the same level, the
finer level at stride 2, the coarser level upsampled), a scale attention
over them and DyReLU. Module names follow the flax tree, so
``convert_from_jax`` and ``models/convert_glip`` fill them; tensors are
channels-last, as in JAX.

The deformable conv is kernel K8 on a CUDA tensor (csrc/deform_conv.cu,
launched by kernels/deform_conv.py) and :func:`deform_conv3x3_plain` on a
CPU one. DyConv runs in f32 whatever the model's dtype, as in JAX: its
input is cast to f32, and the offset net, the scale attention and DyReLU
compute in f32; the block's output is cast back to the model's dtype.
Resizes repeat ``jax.image.resize``: "nearest" at half-pixel centres with
exact integer indices, "bilinear" as ``F.interpolate(align_corners=False)``
(upsampling only, where JAX's antialiasing does nothing).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coin_tpu_torch.models.gdino import BiMultiHeadAttention, _ln
from coin_tpu_torch.models.layers import (Conv2d, GroupNorm32, LayerNorm32,
                                          Linear, cached_constant, conv_nhwc,
                                          set_compute_dtype)
from coin_tpu_torch.models.swin import SWIN_CFGS, SwinTransformer

HIDDEN = 256
LANG_DIM = 768


def h_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def deform_conv3x3_plain(x: torch.Tensor, offsets: torch.Tensor,
                         mask: torch.Tensor, kernel: torch.Tensor,
                         bias: Optional[torch.Tensor],
                         stride: int = 1) -> torch.Tensor:
    """Plain version of K8, JAX's algorithm (glip.py:51-99): per tap, four
    bilinear gathers weighted and zeroed outside the map, summed in the
    order 00, 01, 10, 11, times the mask, then the tap's product with its
    kernel slice summed in f32. x (B, H, W, Cin); offsets (B, Ho, Wo, 18)
    (dy, dx per tap); mask (B, Ho, Wo, 9); kernel (3, 3, Cin, Cout) →
    (B, Ho, Wo, Cout) f32."""
    b, h, w, cin = x.shape
    ho, wo = offsets.shape[1:3]
    dev = x.device
    base_y = (torch.arange(ho, dtype=torch.float32, device=dev)
              * stride)[:, None].expand(ho, wo)
    base_x = (torch.arange(wo, dtype=torch.float32, device=dev)
              * stride)[None, :].expand(ho, wo)
    out = torch.zeros((b, ho, wo, kernel.shape[-1]), dtype=torch.float32,
                      device=dev)
    x_flat = x.reshape(b, h * w, cin)
    for k in range(9):
        ky, kx = k // 3 - 1, k % 3 - 1
        py = base_y[None] + ky + offsets[..., 2 * k]
        px = base_x[None] + kx + offsets[..., 2 * k + 1]
        y0, x0 = torch.floor(py), torch.floor(px)
        fy, fx = py - y0, px - x0

        def tap(yy, xx, wgt):
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = (yy.clamp(0, h - 1).long() * w
                   + xx.clamp(0, w - 1).long())
            v = torch.gather(x_flat, 1, idx.reshape(b, -1, 1).expand(
                -1, -1, cin)).reshape(b, ho, wo, cin)
            wgt = torch.where(inside, wgt, torch.zeros_like(wgt))
            return v * wgt[..., None].to(v.dtype)

        samp = (tap(y0, x0, (1 - fy) * (1 - fx))
                + tap(y0, x0 + 1, (1 - fy) * fx)
                + tap(y0 + 1, x0, fy * (1 - fx))
                + tap(y0 + 1, x0 + 1, fy * fx))
        samp = samp * mask[..., k:k + 1].to(samp.dtype)
        out = out + torch.einsum("bhwc,cd->bhwd", samp.float(),
                                 kernel[ky + 1, kx + 1].float())
    if bias is not None:
        out = out + bias
    return out


def deform_conv3x3(x: torch.Tensor, offsets: torch.Tensor,
                   mask: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor],
                   stride: int = 1, split=None) -> torch.Tensor:
    """K8 on a CUDA tensor, its plain version on a CPU one. ``split``:
    the kernel's TF32 parts for K8, made once by the caller (see
    :class:`Conv3x3Norm`), or None."""
    if x.is_cuda:
        from coin_tpu_torch.kernels.deform_conv import deform_conv_cuda
        return deform_conv_cuda(x, offsets, mask, kernel, bias, stride,
                                split)
    return deform_conv3x3_plain(x, offsets, mask, kernel, bias, stride)


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, h, w, C), "nearest")`` of a channels-last
    tensor: source index floor((i + 0.5) · in / out), computed in integers
    (``F.interpolate``'s "nearest-exact" rounds the scale first)."""
    def index(n_in, n_out):
        return cached_constant(("nearest", n_in, n_out), lambda: (
            (2 * np.arange(n_out) + 1) * n_in // (2 * n_out)).astype(
                np.int64), x.device)
    x = x.index_select(1, index(x.shape[1], h))
    return x.index_select(2, index(x.shape[2], w))


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, h, w, C), "bilinear")`` of a channels-last
    tensor, upsampling: half-pixel centres, edges clamped."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


class Conv3x3Norm(nn.Module):
    """One DyConv branch: K8 with its bias, then GroupNorm(16), in f32.
    ``weight`` is OIHW, as the checkpoint stores it. On the card the
    weight's TF32 split is made at the first call and kept until the
    weight moves or is written."""

    def __init__(self, cin: int = HIDDEN, channels: int = HIDDEN):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, cin, 3, 3))
        nn.init.kaiming_normal_(self.weight)
        self.bias = nn.Parameter(torch.zeros(channels))
        self.gn = GroupNorm32(16, channels)
        self._split = (None, None)      # (key, (hi, lo)) of K8's split

    def _weight_split(self, kernel):
        w = self.weight       # an inference tensor keeps no version
        key = (w.data_ptr(), w.device,
               None if w.is_inference() else w._version)
        if self._split[0] != key:
            from coin_tpu_torch.kernels.deform_conv import split_weights_cuda
            self._split = (key, split_weights_cuda(kernel.detach()))
        return self._split[1]

    def forward(self, x, offsets, mask, stride: int = 1):
        kernel = self.weight.permute(2, 3, 1, 0)
        split = self._weight_split(kernel) if x.is_cuda else None
        y = deform_conv3x3(x.float(), offsets, mask, kernel, self.bias,
                           stride, split)
        return self.gn(y)


class DyReLU(nn.Module):
    """DYReLU-B: per-channel coefficients from the pooled features (a
    contiguous four-way split of fc2's output); max(x·a1 + b1, x·a2 + b2)."""

    def __init__(self, channels: int = HIDDEN):
        super().__init__()
        self.fc1 = Linear(channels, channels // 4)
        self.fc2 = Linear(channels // 4, 4 * channels)

    def forward(self, x):
        y = x.float().mean(dim=(1, 2))
        y = h_sigmoid(self.fc2(F.relu(self.fc1(y))))
        a1, b1, a2, b2 = y.chunk(4, dim=-1)
        a1 = (a1 - 0.5) * 2.0 + 1.0
        a2 = (a2 - 0.5) * 2.0
        b1, b2 = b1 - 0.5, b2 - 0.5
        bc = lambda t: t[:, None, None, :].to(x.dtype)
        return torch.maximum(x * bc(a1) + bc(b1), x * bc(a2) + bc(b2))


class BertEncoderLayer(nn.Module):
    """The tower's language path: a post-LN BERT layer with GLIP's own
    attention (glip.py:143-173): the scores divided by sqrt(head dim)
    after the product, clamped to ±50 000, padded keys at -1e9; flax's
    LayerNorm (ε = 1e-6, f32)."""

    def __init__(self, hidden: int = LANG_DIM, heads: int = 12,
                 inter: int = 3072):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        self.query, self.key, self.value = (Linear(hidden, hidden)
                                            for _ in range(3))
        self.att_out = Linear(hidden, hidden)
        self.att_ln = LayerNorm32(hidden)
        self.inter = Linear(hidden, inter)
        self.out = Linear(inter, hidden)
        self.out_ln = LayerNorm32(hidden)

    def forward(self, lang, lang_mask):
        b, t, _ = lang.shape
        hd = self.hidden // self.heads
        sh = lambda z: z.reshape(b, t, self.heads, hd)
        v = sh(self.value(lang))
        attn = torch.einsum("bqhd,bkhd->bhqk", sh(self.query(lang)).float(),
                            sh(self.key(lang)).float())
        attn = attn / torch.full((), float(np.sqrt(hd)), device=attn.device)
        attn = attn.clamp(-50000.0, 50000.0)
        attn = torch.where(lang_mask[:, None, None, :], attn,
                           torch.full_like(attn, -1e9))
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, -1)
        lang = _ln(self.att_ln, lang + self.att_out(ctx))
        f = self.out(F.gelu(self.inter(lang), approximate="none"))
        return _ln(self.out_ln, lang + f)


class VLDyHeadBlock(nn.Module):
    """One vision-language DyHead block, shared over the levels:
    :meth:`fuse` (VLFuse), :meth:`language` (the BERT layer) and
    :meth:`dyconv`, which callers may also run one by one."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fusion_layer_norm_v = LayerNorm32(HIDDEN)
        self.fusion_layer_norm_l = LayerNorm32(LANG_DIM)
        self.fusion_gamma_v = nn.Parameter(torch.full((HIDDEN,), 1.0 / 8))
        self.fusion_gamma_l = nn.Parameter(torch.full((LANG_DIM,), 1.0 / 8))
        self.fusion_attn = BiMultiHeadAttention(HIDDEN, heads=8, embed=2048,
                                                l_dim=LANG_DIM)
        self.lang_layer = BertEncoderLayer()
        self.dyconv_offset = Conv2d(HIDDEN, 27, 3, padding=1)
        self.dyconv_mid = Conv3x3Norm()
        self.dyconv_low = Conv3x3Norm()
        self.dyconv_high = Conv3x3Norm()
        self.scale_attn_fc = Linear(HIDDEN, 1)
        self.dyrelu = DyReLU()

    def f32_modules(self) -> List[nn.Module]:
        """The layers that compute in f32 whatever the model's dtype."""
        return [self.dyconv_offset, self.scale_attn_fc, self.dyrelu]

    def fuse(self, feats: Sequence[torch.Tensor], lang: torch.Tensor,
             lang_mask: torch.Tensor):
        """VLFuse over the concatenated levels → (levels, lang)."""
        b = feats[0].shape[0]
        vis = torch.cat([f.reshape(b, -1, f.shape[-1]) for f in feats],
                        dim=1)
        dv, dl = self.fusion_attn(_ln(self.fusion_layer_norm_v, vis),
                                  _ln(self.fusion_layer_norm_l, lang),
                                  lang_mask)
        vis = vis + self.fusion_gamma_v.to(vis.dtype) * dv
        lang = lang + self.fusion_gamma_l.to(lang.dtype) * dl
        out, start = [], 0
        for f in feats:
            h, w = f.shape[1:3]
            out.append(vis[:, start:start + h * w].reshape(b, h, w, HIDDEN))
            start += h * w
        return out, lang

    def language(self, lang: torch.Tensor, lang_mask: torch.Tensor):
        return self.lang_layer(lang, lang_mask)

    def dyconv(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """DyConv across neighbouring levels with scale attention: each
        level's offset field (from its own feature) serves its mid branch,
        the finer level sampled at stride 2 (low), and the coarser level's
        high branch, which is then upsampled."""
        fields = []
        for f in feats:
            off = conv_nhwc(self.dyconv_offset, f)
            fields.append((off[..., :18], torch.sigmoid(off[..., 18:])))
        fused_levels = []
        for lvl, f in enumerate(feats):
            h, w = f.shape[1:3]
            offsets, mask = fields[lvl]
            branches = [self.dyconv_mid(f, offsets, mask)]
            if lvl > 0:
                branches.append(self.dyconv_low(
                    feats[lvl - 1], offsets, mask, stride=2)[:, :h, :w])
            if lvl < len(feats) - 1:
                up = self.dyconv_high(feats[lvl + 1], *fields[lvl + 1])
                branches.append(resize_bilinear(up, h, w))
            stacked = torch.stack(branches, dim=0)        # (K, B, H, W, C)
            pooled = stacked.mean(dim=(2, 3), keepdim=True)
            attn = h_sigmoid(F.relu(self.scale_attn_fc(pooled)))
            fused = (stacked * attn).mean(dim=0)
            fused_levels.append(self.dyrelu(fused).to(self.dtype))
        return fused_levels

    def forward(self, feats, lang, lang_mask):
        feats, lang = self.fuse(feats, lang, lang_mask)
        lang = self.language(lang, lang_mask)
        return self.dyconv(feats), lang


class GLIPHead(nn.Module):
    """Per-level predictions: token logits = ⟨feature, text projection of
    lang / 2⟩ / exp(log_scale) + lang · bias_lang + bias0, clamped to
    ±50 000 (f32); box deltas times the level's scale (f32); centerness
    (the model's dtype, as in JAX)."""

    def __init__(self, num_levels: int = 5, num_anchors: int = 1):
        super().__init__()
        self.num_anchors = num_anchors
        self.dot_product_projection_text = Linear(LANG_DIM, HIDDEN)
        self.bias_lang = nn.Parameter(torch.zeros(LANG_DIM))
        self.bias0 = nn.Parameter(torch.zeros(()))
        self.log_scale = nn.Parameter(torch.zeros(()))
        self.bbox_pred = Conv2d(HIDDEN, 4 * num_anchors, 1)
        self.centerness = Conv2d(HIDDEN, num_anchors, 1)
        self.scales = nn.Parameter(torch.ones(num_levels))

    def forward(self, feats: Sequence[torch.Tensor], lang: torch.Tensor):
        embed = self.dot_product_projection_text(lang / 2.0).float()
        tok_bias = lang @ self.bias_lang.to(lang.dtype) + self.bias0
        inv_scale = 1.0 / torch.exp(self.log_scale)
        logits, deltas, centerness = [], [], []
        for lvl, f in enumerate(feats):
            b, h, w, _ = f.shape
            img = f.reshape(b, h * w * self.num_anchors, HIDDEN).float()
            lg = torch.einsum("bnd,btd->bnt", img, embed)
            logits.append((lg * inv_scale + tok_bias[:, None, :]).clamp(
                -50000.0, 50000.0))
            # a 0-d f32 factor would not promote a bf16 tensor in torch
            deltas.append((conv_nhwc(self.bbox_pred, f).float()
                           * self.scales[lvl]).reshape(b, -1, 4))
            centerness.append(conv_nhwc(self.centerness, f).reshape(b, -1))
        return (torch.cat(logits, dim=1), torch.cat(deltas, dim=1),
                torch.cat(centerness, dim=1))


class FPN(nn.Module):
    """maskrcnn_benchmark's FPN over the Swin stages (1×1 laterals, nearest
    top-down, 3×3 outputs) plus RetinaNet's P6/P7 on P5 (P7 from
    relu(P6)); the stride-2 convs pad (1, 1), flax's ``padding=1``."""

    def __init__(self, in_channels: Sequence[int]):
        super().__init__()
        self.n = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"fpn_inner{i + 2}", Conv2d(c, HIDDEN, 1))
            self.add_module(f"fpn_layer{i + 2}",
                            Conv2d(HIDDEN, HIDDEN, 3, padding=1))
        self.top_p6 = Conv2d(HIDDEN, HIDDEN, 3, stride=2, padding=1)
        self.top_p7 = Conv2d(HIDDEN, HIDDEN, 3, stride=2, padding=1)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        inners = [conv_nhwc(getattr(self, f"fpn_inner{i + 2}"), f)
                  for i, f in enumerate(feats)]
        outs: List[torch.Tensor] = [None] * self.n
        last = inners[-1]
        outs[-1] = conv_nhwc(getattr(self, f"fpn_layer{self.n + 1}"), last)
        for i in range(self.n - 2, -1, -1):
            h, w = inners[i].shape[1:3]
            last = inners[i] + resize_nearest(last, h, w)
            outs[i] = conv_nhwc(getattr(self, f"fpn_layer{i + 2}"), last)
        p6 = conv_nhwc(self.top_p6, outs[-1])
        p7 = conv_nhwc(self.top_p7, F.relu(p6))
        return outs + [p6, p7]


class GLIP(nn.Module):
    """Swin → FPN (+P6/P7) → ``num_blocks`` VLDyHead blocks → head.

    ``forward(images (B, H, W, 3) ImageNet-normalised, bert_embeds
    (B, T, 768), lang_mask (B, T) bool)`` → (token logits (B, R, T) f32,
    box deltas (B, R, 4) f32, centerness (B, R), the level shapes). The
    stages may also be run one by one: ``backbone``, ``fpn``, each block's
    ``fuse`` / ``language`` / ``dyconv``, ``head``."""

    def __init__(self, variant: str = "swinL", num_blocks: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.variant, self.num_blocks, self.dtype = variant, num_blocks, dtype
        self.backbone = SwinTransformer(variant)
        embed = SWIN_CFGS[variant]["embed_dim"]
        self.fpn = FPN((embed * 2, embed * 4, embed * 8))
        for i in range(num_blocks):
            self.add_module(f"dyhead_{i}", VLDyHeadBlock(dtype))
        self.head = GLIPHead()
        set_compute_dtype(self, dtype)
        for blk in self.blocks():
            for m in blk.f32_modules():
                set_compute_dtype(m, torch.float32)

    def blocks(self) -> List[VLDyHeadBlock]:
        return [getattr(self, f"dyhead_{i}") for i in range(self.num_blocks)]

    def forward(self, images: torch.Tensor, bert_embeds: torch.Tensor,
                lang_mask: torch.Tensor):
        levels = self.fpn(self.backbone(images.to(self.dtype)))
        lang = bert_embeds
        for blk in self.blocks():
            levels, lang = blk(levels, lang, lang_mask)
        shapes: List[Tuple[int, int]] = [(f.shape[1], f.shape[2])
                                         for f in levels]
        logits, deltas, centerness = self.head(levels, lang)
        return logits, deltas, centerness, shapes
