"""OpenVocabularyRCNN, the CLIPDET / target-detector meta-architecture
(counterpart of coin_tpu/models/detector.py:35-189).

CLIP-ResNet C4 backbone → RPN head → RoIAlign(res4) → res5 on the
collapsed B·N crop batch → mean pool (or CLIP's attention pool under
``pooling="attnpool"``) → cosine classifier against
learnable-prompt text features + box regression, class-agnostic or, with
``box_reg_classes`` = C, per class.
Every parameter is held in f32, as flax keeps them; convolutions and the
text tower's linears cast their weights to the compute dtype at each call
(``models/layers.py``), while FrozenBN statistics, embeddings, LayerNorms
and the box predictor compute in f32, as the JAX package does.
"""

from __future__ import annotations

import copy
import itertools

import torch
from torch import nn

from coin_tpu_torch.models.clip_resnet import (DEPTH_CFG, AttentionPool2d,
                                               CLIPResNetBackbone, QConv2d,
                                               Res5Head)
from coin_tpu_torch.models.layers import Conv2d, lecun_normal_
from coin_tpu_torch.models.roi_heads import BoxPredictor
from coin_tpu_torch.models.rpn import RPNHead
from coin_tpu_torch.models.text_encoder import (PromptedTextEncoder,
                                                ResidualAttentionBlock,
                                                TextTransformer)
from coin_tpu_torch.ops.roi_align import (roi_align_batched,
                                          roi_align_int8_batched)

# CLIP text-feature dims per visual backbone (coin_tpu/models/detector.py:32)
TEXT_DIMS = {50: 1024, 101: 512, 200: 640, 800: 768}


class OpenVocabularyRCNN(nn.Module):
    def __init__(self, num_classes: int, depth: int = 50,
                 num_anchors: int = 15, add_prompt_num: int = 4,
                 prompt_tmp_len: int = 4, text_layers: int = 12,
                 text_width: int = 512, text_heads: int = 8,
                 compute_dtype: torch.dtype = torch.float32,
                 quant_convs: bool = False, quant_train_res5: int = 0,
                 quant_roi: bool = False, pooling: str = "meanpool",
                 box_reg_classes: int = 1):
        super().__init__()
        cfg = DEPTH_CFG[depth]
        self.num_classes = num_classes
        # 1: class-agnostic deltas; num_classes: a column of 4 per class
        self.box_reg_classes = box_reg_classes
        self.compute_dtype = compute_dtype
        # TPU.INT8_ROI: pool_boxes runs the int8 RoIAlign (K5); clone()
        # keeps it, as flax's clone keeps every field
        self.quant_roi = bool(quant_roi)
        self.text_dim = TEXT_DIMS[depth]
        self.backbone = CLIPResNetBackbone(depth)
        self.rpn_head = RPNHead(cfg["width"] * 16, num_anchors)
        self.res5 = Res5Head(depth)
        if pooling not in ("meanpool", "attnpool"):
            raise ValueError(f"pooling {pooling!r} (meanpool or attnpool)")
        self.pooling = pooling
        feat_dim = cfg["width"] * 32          # res5 channels (2048, RN50)
        if pooling == "attnpool":
            self.attnpool = AttentionPool2d(feat_dim, cfg["heads"],
                                            self.text_dim)
            feat_dim = self.text_dim
        self.box_predictor = BoxPredictor(feat_dim, self.text_dim,
                                          box_dim=4 * box_reg_classes)
        self.text_trunk = TextTransformer(width=text_width, heads=text_heads,
                                          layers=text_layers,
                                          embed_dim=self.text_dim)
        self.prompted_text = PromptedTextEncoder(text_width, prompt_tmp_len,
                                                 add_prompt_num)
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.compute_dtype = compute_dtype
            elif isinstance(m, ResidualAttentionBlock):
                for lin in (m.attn.query, m.attn.key, m.attn.value,
                            m.attn.out, m.mlp_c_fc, m.mlp_c_proj):
                    lin.compute_dtype = compute_dtype
        self.set_quant(quant_convs, quant_train_res5)

    def set_quant(self, quant_convs: bool, quant_train_res5: int) -> None:
        """The int8 switches of coin_tpu/models/detector.py:52-62:
        ``quant_convs`` makes every backbone and res5 conv the int8 serving
        conv (K2s); ``quant_train_res5`` (0-4, ``_conv``'s ``qt``) makes the
        res5 convs the int8 training conv (K2), which wins over
        ``quant_convs`` there."""
        self.quant_convs = bool(quant_convs)
        self.quant_train_res5 = int(quant_train_res5)
        for m in self.backbone.modules():
            if isinstance(m, QConv2d):
                m.quant = self.quant_convs
        for m in self.res5.modules():
            if isinstance(m, QConv2d):
                m.quant, m.qt = self.quant_convs, self.quant_train_res5

    def clone(self, quant_convs: bool) -> "OpenVocabularyRCNN":
        """flax's ``model.clone(quant_convs=...)``: the same detector with
        other int8 switches, sharing every parameter and buffer with this
        one (no copy; an update of either is seen by both)."""
        memo = {id(t): t for t in itertools.chain(self.parameters(),
                                                  self.buffers())}
        twin = copy.deepcopy(self, memo)
        twin.set_quant(quant_convs, self.quant_train_res5)
        return twin

    @torch.no_grad()
    def random_init(self, seed: int) -> "OpenVocabularyRCNN":
        """Random weights from ``seed``, drawn on the CPU so that every
        device gets the same ones, from the distribution of the flax
        initialiser that each JAX module declares: LeCun-normal kernels
        (truncated at 2 σ, :func:`lecun_normal_`), zero biases, unit
        LayerNorm scales, identity FrozenBN (buffers, left as built), and
        plain normals where the JAX module names its own scale (the text
        tower's embeddings and projection, the prompts, the attention
        pool's positional embedding, the classifier and box deltas)."""
        gen = torch.Generator().manual_seed(seed)
        width = self.text_trunk.text_projection.shape[0]
        scales = {
            # nn.Embed's default: variance_scaling(1, fan_in, normal) over
            # (vocab, width), fan_in = width
            "text_trunk.token_embedding.weight": width ** -0.5,
            "text_trunk.positional_embedding": 0.01,
            "text_trunk.text_projection": width ** -0.5,
            "prompted_text.embedding_tmp": 0.02,
            "prompted_text.add_in_embedding": 0.02,
            "box_predictor.cls_score.weight": 0.01,
            "box_predictor.bbox_pred.weight": 0.001}
        if self.pooling == "attnpool":
            pos = self.attnpool.positional_embedding
            scales["attnpool.positional_embedding"] = pos.shape[1] ** -0.5
        for name, p in self.named_parameters():
            if name in scales:
                p.copy_(torch.randn(p.shape, generator=gen) * scales[name])
            elif name.endswith("bias") or p.dim() == 1:
                p.zero_()
                if name.endswith("weight"):   # LayerNorm scale
                    p.fill_(1.0)
            else:
                lecun_normal_(p, gen)
        return self

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) normalised → res4 (B, H/16, W/16, C4)."""
        return self.backbone(images, self.compute_dtype)

    def rpn(self, feats: torch.Tensor):
        return self.rpn_head(feats)

    def pool_boxes(self, feats: torch.Tensor, boxes: torch.Tensor,
                   resolution: int = 14) -> torch.Tensor:
        """RoIAlign(res4, stride 16; in int8 under ``quant_roi``) → res5 →
        mean pool (the compute dtype) or attention pool (f32): feats (B,
        h, w, C), boxes (B, N, 4) image coordinates → (B, N, D)."""
        ra = roi_align_int8_batched if self.quant_roi else roi_align_batched
        x = ra(feats, boxes, 1.0 / 16.0, resolution, 2)
        return self._pool(self.res5(x.flatten(0, 1)), x.shape[:2])

    def pool_boxes_fast(self, feats: torch.Tensor, boxes: torch.Tensor,
                        resolution: int = 7) -> torch.Tensor:
        """The teacher's fast head (``TPU.TEACHER_FAST_HEAD``): res5 over
        the whole res4 map once, then RoIAlign (K1) of the res5 map at
        stride 32, then the mean or attention pool: feats (B, h, w, C),
        boxes (B, N, 4) → (B, N, D). The same parameters and output as
        :meth:`pool_boxes`; the features differ at crop borders (the
        image's context instead of the crop's padding). The float
        RoIAlign also under ``quant_roi``, as in the JAX package."""
        f5 = self.res5(feats)                 # (B, h/2, w/2, 2048)
        x = roi_align_batched(f5, boxes, 1.0 / 32.0, resolution, 2)
        return self._pool(x.flatten(0, 1), x.shape[:2])

    def _pool(self, x: torch.Tensor, lead) -> torch.Tensor:
        """res5 features of the crops (B·N, r, r, C) → the mean pool (in
        the compute dtype) or the attention pool (f32), (B, N, D)."""
        if self.pooling == "attnpool":
            return self.attnpool(x).reshape(*lead, -1)
        return x.mean(dim=(1, 2), dtype=torch.float32).to(x.dtype) \
            .reshape(*lead, -1)

    def predict(self, pooled: torch.Tensor, text_features: torch.Tensor):
        """pooled (..., D) → scores (..., C+1), deltas (..., 4 · K),
        class_feats (..., text_dim), in f32; K = ``box_reg_classes``."""
        flat = pooled.reshape(-1, pooled.shape[-1]).float()
        class_feats, deltas = self.box_predictor(flat)
        scores = self.box_predictor.classify(class_feats, text_features)
        lead = pooled.shape[:-1]
        return (scores.reshape(lead + (-1,)),
                deltas.reshape(lead + (4 * self.box_reg_classes,)),
                class_feats.reshape(lead + (-1,)))

    def text_features(self, class_tokens: torch.Tensor) -> torch.Tensor:
        """Learnable-prompt text features (C+1, text_dim), normalised;
        class_tokens (C+1, 77) int tokens."""
        embeds = self.text_trunk.token_embedding(class_tokens)
        return self.prompted_text(self.text_trunk, embeds,
                                  class_tokens.argmax(dim=-1))
