"""Grounding DINO cloud teacher (counterpart of coin_tpu/models/gdino.py):
Swin image backbone → (BERT states projected to 256) → feature enhancer
(deformable image self-attention, text self-attention, bidirectional
image↔text fusion) → language-guided query selection → cross-modality
decoder → contrastive logits against the text tokens.

Module names follow the flax tree, so ``convert_from_jax`` and
``models/convert_gdino`` fill them. Tensors are channels-last, as in JAX.
Linears and convs compute in the model's dtype over f32 masters
(``layers.set_compute_dtype``); LayerNorm and GroupNorm compute in f32
with flax's ε = 1e-6 and are cast back.

``MHA`` and the bi-attention are plain tensor code in JAX's order:
product, scale, ``where(mask, ·, -1e9)`` (or the ±50 000 clamp and the
max subtraction), softmax in f32, then a cast. They do not use
``scaled_dot_product_attention``, whose −inf masking differs from JAX's
−1e9. The deformable sampling is kernel K7 and Swin's window attention
kernel K9 (``models/deformable.py``, ``models/swin.py``).

``forward`` runs five stages that callers may also run one by one:
``backbone``, ``project`` (input projections, positions), ``enhance``,
``select_queries`` and ``decode``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coin_tpu_torch.models.deformable import MSDeformAttention
from coin_tpu_torch.models.layers import (Conv2d, GroupNorm32, LayerNorm32,
                                          Linear, cached_constant, conv_nhwc,
                                          set_compute_dtype)
from coin_tpu_torch.models.rpn import topk_stable
from coin_tpu_torch.models.swin import SWIN_CFGS, SwinTransformer

HIDDEN = 256


def sine_position_embedding(h: int, w: int, dim: int = HIDDEN,
                            temperature: float = 20.0) -> np.ndarray:
    """GroundingDINO's sine embedding (temperatureH=temperatureW=20),
    normalized to 2π, (H·W, dim)."""
    scale = 2 * np.pi
    eps = 1e-6
    y = (np.arange(h, dtype=np.float32) + 0.5) / (h + eps) * scale
    x = (np.arange(w, dtype=np.float32) + 0.5) / (w + eps) * scale
    dim_t = temperature ** (2 * (np.arange(dim // 2) // 2)
                            / (dim // 2))
    pos_x = x[:, None] / dim_t[None]
    pos_y = y[:, None] / dim_t[None]
    pos_x = np.stack([np.sin(pos_x[:, 0::2]), np.cos(pos_x[:, 1::2])],
                     axis=2).reshape(w, -1)
    pos_y = np.stack([np.sin(pos_y[:, 0::2]), np.cos(pos_y[:, 1::2])],
                     axis=2).reshape(h, -1)
    pos = np.concatenate([
        np.repeat(pos_y[:, None, :], w, axis=1),
        np.repeat(pos_x[None, :, :], h, axis=0)], axis=-1)
    return pos.reshape(h * w, dim)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def box_sine_embedding(boxes: torch.Tensor, dim: int = 128) -> torch.Tensor:
    """DAB-DETR sine embedding of (cx, cy, w, h) → (..., 4·dim), ordered
    (y, x, w, h): the official ref_point_head's 512-wide input."""
    dim_t = cached_constant(("dim_t", dim), lambda: (10000.0 ** (
        2 * (np.arange(dim) // 2) / dim)).astype(np.float32), boxes.device)

    def embed(v):
        p = v[..., None] * (2 * np.pi) / dim_t
        return torch.cat([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                         dim=-1)
    cx, cy, w, h = (embed(boxes[..., i]) for i in range(4))
    return torch.cat([cy, cx, w, h], dim=-1)


def contrastive_logits(queries: torch.Tensor, text: torch.Tensor,
                       text_mask: torch.Tensor) -> torch.Tensor:
    """ContrastiveEmbed: queries · text in f32, masked tokens at −inf."""
    logits = torch.einsum("bqd,btd->bqt", queries.float(), text.float())
    return torch.where(text_mask[:, None, :], logits,
                       torch.full_like(logits, float("-inf")))


def _ln(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """flax's f32 LayerNorm, cast back to the input's dtype."""
    return norm(x).to(x.dtype)


class MLP(nn.Module):
    def __init__(self, d_in: int, hidden: int, out: int, layers: int = 3):
        super().__init__()
        self.n = layers
        dims = [d_in] + [hidden] * (layers - 1) + [out]
        for i in range(layers):
            self.add_module(f"layers_{i}", Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.n - 1):
            x = F.relu(getattr(self, f"layers_{i}")(x))
        return getattr(self, f"layers_{self.n - 1}")(x)


class MHA(nn.Module):
    """torch ``nn.MultiheadAttention`` semantics with separate q/k/v."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.q, self.k, self.v = Linear(dim, dim), Linear(dim, dim), \
            Linear(dim, dim)
        self.out_proj = Linear(dim, dim)

    def forward(self, q, k, v, mask: Optional[torch.Tensor] = None):
        hd = self.dim // self.heads
        sh = lambda t: t.reshape(t.shape[0], -1, self.heads, hd)
        qq, kk, vv = sh(self.q(q)), sh(self.k(k)), sh(self.v(v))
        attn = torch.einsum("bqhd,bkhd->bhqk", qq.float(), kk.float())
        # a tensor divisor: PyTorch's CUDA kernels multiply by the
        # reciprocal of a scalar one, an ulp off JAX's division
        attn = attn / torch.full((), float(np.sqrt(hd)), device=attn.device)
        if mask is not None:
            attn = torch.where(mask, attn, torch.full_like(attn, -1e9))
        attn = torch.softmax(attn, dim=-1).to(vv.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vv)
        return self.out_proj(out.reshape(q.shape[0], -1, self.dim))


class BiMultiHeadAttention(nn.Module):
    """Bidirectional image↔text fusion (GLIP / GroundingDINO
    BiAttention). ``l_dim`` is the language side's width, in and out:
    GroundingDINO fuses 256-wide text (None: ``dim``), GLIP's VLFuse the
    768-wide BERT states (coin_tpu/models/gdino.py:101-139)."""

    def __init__(self, dim: int = HIDDEN, heads: int = 4, embed: int = 1024,
                 l_dim: Optional[int] = None):
        super().__init__()
        self.heads, self.embed = heads, embed
        l_dim = l_dim or dim
        self.v_proj = Linear(dim, embed)
        self.l_proj = Linear(l_dim, embed)
        self.values_v_proj = Linear(dim, embed)
        self.values_l_proj = Linear(l_dim, embed)
        self.out_v_proj = Linear(embed, dim)
        self.out_l_proj = Linear(embed, l_dim)

    def forward(self, vis, lang, lang_mask):
        hd = self.embed // self.heads
        q = self.v_proj(vis) * hd ** -0.5
        k = self.l_proj(lang)
        vv = self.values_v_proj(vis)
        vl = self.values_l_proj(lang)
        b = vis.shape[0]
        sh = lambda t: t.reshape(b, -1, self.heads, hd)
        attn = torch.einsum("bvhd,blhd->bhvl", sh(q).float(), sh(k).float())
        attn = attn.clamp(-50000.0, 50000.0)
        attn_v = attn - attn.amax(dim=-1, keepdim=True)
        attn_v = torch.where(lang_mask[:, None, None, :], attn_v,
                             torch.full_like(attn_v, -1e9))
        attn_v = torch.softmax(attn_v, dim=-1)
        attn_l = attn - attn.amax(dim=-2, keepdim=True)
        attn_l = torch.softmax(attn_l, dim=-2)
        out_v = torch.einsum("bhvl,blhd->bvhd", attn_v.to(vl.dtype),
                             sh(vl)).reshape(b, -1, self.embed)
        out_l = torch.einsum("bhvl,bvhd->blhd", attn_l.to(vv.dtype),
                             sh(vv)).reshape(b, -1, self.embed)
        return self.out_v_proj(out_v), self.out_l_proj(out_l)


class FusionLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.layer_norm_v = LayerNorm32(HIDDEN)
        self.layer_norm_l = LayerNorm32(HIDDEN)
        self.gamma_v = nn.Parameter(torch.full((HIDDEN,), 1e-4))
        self.gamma_l = nn.Parameter(torch.full((HIDDEN,), 1e-4))
        self.attn = BiMultiHeadAttention()

    def forward(self, vis, lang, lang_mask):
        dv, dl = self.attn(_ln(self.layer_norm_v, vis),
                           _ln(self.layer_norm_l, lang), lang_mask)
        vis = vis + self.gamma_v.to(vis.dtype) * dv
        lang = lang + self.gamma_l.to(lang.dtype) * dl
        return vis, lang


class TextSelfAttnLayer(nn.Module):
    def __init__(self, heads: int = 4):
        super().__init__()
        self.self_attn = MHA(HIDDEN, heads)
        self.norm1 = LayerNorm32(HIDDEN)
        self.linear1 = Linear(HIDDEN, 1024)
        self.linear2 = Linear(1024, HIDDEN)
        self.norm2 = LayerNorm32(HIDDEN)

    def forward(self, lang, self_mask):
        h = self.self_attn(lang, lang, lang, self_mask)
        lang = _ln(self.norm1, lang + h)
        f = self.linear2(F.relu(self.linear1(lang)))
        return _ln(self.norm2, lang + f)


class ImageEncoderLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.self_attn = MSDeformAttention()
        self.norm1 = LayerNorm32(HIDDEN)
        self.linear1 = Linear(HIDDEN, 2048)
        self.linear2 = Linear(2048, HIDDEN)
        self.norm2 = LayerNorm32(HIDDEN)

    def forward(self, src, pos, reference_points, spatial_shapes,
                level_starts):
        h = self.self_attn(src + pos, reference_points, src, spatial_shapes,
                           level_starts)
        src = _ln(self.norm1, src + h)
        f = self.linear2(F.relu(self.linear1(src)))
        return _ln(self.norm2, src + f)


class DecoderLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.self_attn = MHA(HIDDEN, 8)
        self.norm2 = LayerNorm32(HIDDEN)
        self.ca_text = MHA(HIDDEN, 4)
        self.catext_norm = LayerNorm32(HIDDEN)
        self.cross_attn = MSDeformAttention()
        self.norm1 = LayerNorm32(HIDDEN)
        self.linear1 = Linear(HIDDEN, 2048)
        self.linear2 = Linear(2048, HIDDEN)
        self.norm3 = LayerNorm32(HIDDEN)

    def forward(self, tgt, query_pos, memory, text, text_mask,
                reference_points, spatial_shapes, level_starts):
        q = tgt + query_pos
        tgt = _ln(self.norm2, tgt + self.self_attn(q, q, tgt))
        h = self.ca_text(tgt + query_pos, text, text,
                         text_mask[:, None, None, :])
        tgt = _ln(self.catext_norm, tgt + h)
        h = self.cross_attn(tgt + query_pos, reference_points, memory,
                            spatial_shapes, level_starts)
        tgt = _ln(self.norm1, tgt + h)
        f = self.linear2(F.relu(self.linear1(tgt)))
        return _ln(self.norm3, tgt + f)


def same_pad_stride2(x: torch.Tensor, k: int = 3) -> torch.Tensor:
    """XLA's 'SAME' padding of a k×k, stride-2 conv on a channels-last
    tensor: output ceil(n / 2), the odd pixel of the total padding at the
    high end (flax pads (0, 1) where torch's ``padding=1`` pads (1, 1))."""
    pads = []
    for n in (x.shape[2], x.shape[1]):            # F.pad: last dims first
        total = max((-(-n // 2) - 1) * 2 + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, (0, 0) + tuple(pads))


def _grid_refs(shapes) -> np.ndarray:
    """(ΣHW, 2) normalised (x, y) cell centres of every level."""
    refs = []
    for (h, w) in shapes:
        yy = (np.arange(h, dtype=np.float32) + 0.5) / h
        xx = (np.arange(w, dtype=np.float32) + 0.5) / w
        refs.append(np.stack(np.meshgrid(xx, yy, indexing="xy"),
                             axis=-1).reshape(-1, 2))
    return np.concatenate(refs, axis=0)


class GroundingDINO(nn.Module):
    def __init__(self, variant: str = "swinB", num_queries: int = 900,
                 enc_layers: int = 6, dec_layers: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.variant, self.num_queries = variant, num_queries
        self.enc_layers, self.dec_layers = enc_layers, dec_layers
        self.dtype = dtype
        self.backbone = SwinTransformer(variant)
        embed = SWIN_CFGS[variant]["embed_dim"]
        chans = [embed * 2, embed * 4, embed * 8]
        for i in range(3):
            self.add_module(f"input_proj_{i}_conv",
                            Conv2d(chans[i], HIDDEN, 1))
            self.add_module(f"input_proj_{i}_gn", GroupNorm32(32, HIDDEN))
        self.input_proj_3_conv = Conv2d(chans[-1], HIDDEN, 3, stride=2)
        self.input_proj_3_gn = GroupNorm32(32, HIDDEN)
        self.feat_map = Linear(768, HIDDEN)
        self.level_embed = nn.Parameter(torch.zeros(4, HIDDEN))
        for i in range(enc_layers):
            self.add_module(f"fusion_{i}", FusionLayer())
            self.add_module(f"text_layer_{i}", TextSelfAttnLayer())
            self.add_module(f"enc_layer_{i}", ImageEncoderLayer())
        self.enc_output = Linear(HIDDEN, HIDDEN)
        self.enc_output_norm = LayerNorm32(HIDDEN)
        self.enc_out_bbox_embed = MLP(HIDDEN, HIDDEN, 4)
        self.tgt_embed = nn.Parameter(torch.zeros(num_queries, HIDDEN))
        for i in range(dec_layers):
            self.add_module(f"dec_layer_{i}", DecoderLayer())
            self.add_module(f"bbox_embed_{i}", MLP(HIDDEN, HIDDEN, 4))
        self.decoder_norm = LayerNorm32(HIDDEN)
        self.ref_point_head = MLP(2 * HIDDEN, HIDDEN, HIDDEN, layers=2)
        set_compute_dtype(self, dtype)

    # ------------------------------------------------------------ stages
    def project(self, feats: Sequence[torch.Tensor]):
        """Swin levels → (src (B, ΣHW, 256), pos, shapes, level_starts):
        three 1×1 projections and a 3×3 stride-2 extra level, each with
        GroupNorm(32); sine positions plus the level embedding."""
        b = feats[0].shape[0]
        srcs = [getattr(self, f"input_proj_{i}_gn")(conv_nhwc(
            getattr(self, f"input_proj_{i}_conv"), f))
            for i, f in enumerate(feats)]
        srcs.append(self.input_proj_3_gn(conv_nhwc(
            self.input_proj_3_conv, same_pad_stride2(feats[-1]))))
        shapes = [(x.shape[1], x.shape[2]) for x in srcs]
        starts = [0]
        for (h, w) in shapes[:-1]:
            starts.append(starts[-1] + h * w)
        src = torch.cat([x.to(self.dtype).reshape(b, -1, HIDDEN)
                         for x in srcs], dim=1)
        pos = torch.cat([
            cached_constant(("sine", h, w),
                            lambda: sine_position_embedding(h, w),
                            src.device)[None]
            + self.level_embed[lvl][None, None]
            for lvl, (h, w) in enumerate(shapes)], dim=1).to(src.dtype)
        return src, pos, shapes, starts

    def enhance(self, src, pos, shapes, starts, bert_embeds, text_mask,
                text_self_mask=None):
        """The feature enhancer: → (src, lang)."""
        b = src.shape[0]
        refs = cached_constant(("grid",) + tuple(shapes),
                               lambda: _grid_refs(shapes), src.device)
        refs = refs[None, :, None, :].expand(b, -1, 4, 2)
        lang = self.feat_map(bert_embeds)
        if text_self_mask is None:
            text_self_mask = text_mask[:, None, None, :]
        for i in range(self.enc_layers):
            src, lang = getattr(self, f"fusion_{i}")(src, lang, text_mask)
            lang = getattr(self, f"text_layer_{i}")(lang, text_self_mask)
            src = getattr(self, f"enc_layer_{i}")(src, pos, refs, shapes,
                                                  starts)
        return src, lang

    def select_queries(self, src, lang, text_mask, shapes) -> torch.Tensor:
        """Language-guided query selection → reference boxes
        (B, num_queries, 4) cxcywh in [0, 1], f32."""
        b = src.shape[0]
        memory = _ln(self.enc_output_norm, self.enc_output(src))
        enc_logits = contrastive_logits(memory, lang, text_mask)
        _, topk_idx = topk_stable(enc_logits.amax(dim=-1), self.num_queries)

        def anchors():
            base_wh = np.concatenate([
                np.full((h * w, 2), 0.05 * (2 ** lvl), np.float32)
                for lvl, (h, w) in enumerate(shapes)], axis=0)
            return np.concatenate([_grid_refs(shapes), base_wh], axis=-1)
        anchor = cached_constant(("anchors",) + tuple(shapes), anchors,
                                 src.device)
        anchor_logits = inverse_sigmoid(anchor)[None].expand(b, -1, 4)
        delta = self.enc_out_bbox_embed(memory)
        enc_boxes = torch.sigmoid(anchor_logits + delta)
        return torch.gather(enc_boxes, 1,
                            topk_idx[..., None].expand(-1, -1, 4))

    def decode(self, src, lang, text_mask, ref_boxes, shapes, starts):
        """The decoder from the selected reference boxes → (logits
        (B, nq, T) f32, boxes (B, nq, 4) cxcywh in [0, 1], f32)."""
        b = src.shape[0]
        tgt = self.tgt_embed[None].expand(b, -1, -1).to(src.dtype)
        for i in range(self.dec_layers):
            query_pos = self.ref_point_head(
                box_sine_embedding(ref_boxes).to(src.dtype))
            ref4 = ref_boxes[:, :, None, :].expand(-1, -1, 4, 4)
            tgt = getattr(self, f"dec_layer_{i}")(
                tgt, query_pos, src, lang, text_mask, ref4, shapes, starts)
            delta = getattr(self, f"bbox_embed_{i}")(
                _ln(self.decoder_norm, tgt))
            ref_boxes = torch.sigmoid(inverse_sigmoid(ref_boxes)
                                      + delta.float())
        out = _ln(self.decoder_norm, tgt)
        return contrastive_logits(out, lang, text_mask), ref_boxes

    def forward(self, images: torch.Tensor, bert_embeds: torch.Tensor,
                text_mask: torch.Tensor,
                text_self_mask: Optional[torch.Tensor] = None):
        """images (B, H, W, 3) ImageNet-normalised; bert_embeds (B, T, 768);
        text_mask (B, T) bool; text_self_mask (B, 1, T, T) bool →
        (logits (B, nq, T), boxes (B, nq, 4) cxcywh normalised)."""
        feats = self.backbone(images.to(self.dtype))
        src, pos, shapes, starts = self.project(feats)
        src, lang = self.enhance(src, pos, shapes, starts, bert_embeds,
                                 text_mask, text_self_mask)
        ref_boxes = self.select_queries(src, lang, text_mask, shapes)
        return self.decode(src, lang, text_mask, ref_boxes, shapes, starts)
