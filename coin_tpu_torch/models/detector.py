"""OpenVocabularyRCNN, the CLIPDET / target-detector meta-architecture
(counterpart of coin_tpu/models/detector.py:35-189, mean pooling only).

CLIP-ResNet C4 backbone → RPN head → RoIAlign(res4) → res5 on the
collapsed B·N crop batch → mean pool → cosine classifier against
learnable-prompt text features + class-agnostic box regression.
Convolutions and the text tower's linears hold their weights in the
compute dtype; FrozenBN statistics, embeddings, LayerNorms and the box
predictor stay in f32, as the JAX package computes them.
"""

from __future__ import annotations

import torch
from torch import nn

from coin_tpu_torch.models.clip_resnet import (DEPTH_CFG, CLIPResNetBackbone,
                                               Res5Head)
from coin_tpu_torch.models.roi_heads import BoxPredictor
from coin_tpu_torch.models.rpn import RPNHead
from coin_tpu_torch.models.text_encoder import (PromptedTextEncoder,
                                                ResidualAttentionBlock,
                                                TextTransformer)
from coin_tpu_torch.ops.roi_align import roi_align_batched

# CLIP text-feature dims per visual backbone (coin_tpu/models/detector.py:32)
TEXT_DIMS = {50: 1024, 101: 512, 200: 640, 800: 768}


class OpenVocabularyRCNN(nn.Module):
    def __init__(self, num_classes: int, depth: int = 50,
                 num_anchors: int = 15, add_prompt_num: int = 4,
                 prompt_tmp_len: int = 4, text_layers: int = 12,
                 text_width: int = 512, text_heads: int = 8,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = DEPTH_CFG[depth]
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.text_dim = TEXT_DIMS[depth]
        self.backbone = CLIPResNetBackbone(depth)
        self.rpn_head = RPNHead(cfg["width"] * 16, num_anchors)
        self.res5 = Res5Head(depth)
        self.box_predictor = BoxPredictor(cfg["width"] * 32, self.text_dim)
        self.text_trunk = TextTransformer(width=text_width, heads=text_heads,
                                          layers=text_layers,
                                          embed_dim=self.text_dim)
        self.prompted_text = PromptedTextEncoder(text_width, prompt_tmp_len,
                                                 add_prompt_num)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(compute_dtype)
            elif isinstance(m, ResidualAttentionBlock):
                for lin in (m.attn.query, m.attn.key, m.attn.value,
                            m.attn.out, m.mlp_c_fc, m.mlp_c_proj):
                    lin.to(compute_dtype)

    @torch.no_grad()
    def random_init(self, seed: int) -> "OpenVocabularyRCNN":
        """Random weights from ``seed``, drawn on the CPU so that every
        device gets the same ones: flax's initialisers of the JAX modules
        (LeCun-normal kernels, zero biases, identity FrozenBN, the normal
        scales of the text and predictor parameters)."""
        gen = torch.Generator().manual_seed(seed)
        scales = {"text_trunk.token_embedding.weight": 0.02,
                  "text_trunk.positional_embedding": 0.01,
                  "text_trunk.text_projection":
                      self.text_trunk.text_projection.shape[0] ** -0.5,
                  "prompted_text.embedding_tmp": 0.02,
                  "prompted_text.add_in_embedding": 0.02,
                  "box_predictor.cls_score.weight": 0.01,
                  "box_predictor.bbox_pred.weight": 0.001}
        for name, p in self.named_parameters():
            if name in scales:
                std = scales[name]
            elif name.endswith("bias") or p.dim() == 1:
                p.zero_()
                if name.endswith("weight"):   # LayerNorm scale
                    p.fill_(1.0)
                continue
            else:
                std = (p[0].numel()) ** -0.5  # fan_in of (out, in, ...)
            p.copy_(torch.randn(p.shape, generator=gen) * std)
        return self

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) normalised → res4 (B, H/16, W/16, C4)."""
        return self.backbone(images, self.compute_dtype)

    def rpn(self, feats: torch.Tensor):
        return self.rpn_head(feats)

    def pool_boxes(self, feats: torch.Tensor, boxes: torch.Tensor,
                   resolution: int = 14) -> torch.Tensor:
        """RoIAlign(res4, stride 16) → res5 → mean pool: feats
        (B, h, w, C), boxes (B, N, 4) image coordinates → (B, N, D)."""
        x = roi_align_batched(feats, boxes, 1.0 / 16.0, resolution, 2)
        b, n = x.shape[:2]
        x = self.res5(x.reshape((b * n,) + x.shape[2:]))
        return x.mean(dim=(1, 2), dtype=torch.float32).to(x.dtype) \
            .reshape(b, n, -1)

    def predict(self, pooled: torch.Tensor, text_features: torch.Tensor):
        """pooled (..., D) → scores (..., C+1), deltas (..., 4),
        class_feats (..., text_dim), in f32."""
        flat = pooled.reshape(-1, pooled.shape[-1]).float()
        class_feats, deltas = self.box_predictor(flat)
        scores = self.box_predictor.classify(class_feats, text_features)
        lead = pooled.shape[:-1]
        return (scores.reshape(lead + (-1,)), deltas.reshape(lead + (4,)),
                class_feats.reshape(lead + (-1,)))

    def text_features(self, class_tokens: torch.Tensor) -> torch.Tensor:
        """Learnable-prompt text features (C+1, text_dim), normalised;
        class_tokens (C+1, 77) int tokens."""
        embeds = self.text_trunk.token_embedding(class_tokens)
        return self.prompted_text(self.text_trunk, embeds,
                                  class_tokens.argmax(dim=-1))
