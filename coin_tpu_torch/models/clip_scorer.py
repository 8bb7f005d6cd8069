"""Zero-shot CLIP box scorer (counterpart of coin_tpu/models/clip_scorer.py).

A frozen CLIP visual tower classifies given boxes: RoIAlign of res4 (K1:
scale 1/16, 14 x 14, sampling ratio 2) → res5 → attention pool → cosine
similarity with frozen per-class text features × exp(logit_scale) →
softmax over the classes and the background column. The collection stage
uses it to re-score the cached cloud detections (``engine/collect.
rescore_with_clip``), dropping the boxes it calls background.
"""

from __future__ import annotations

import torch
from torch import nn

from coin_tpu_torch.models.clip_resnet import (DEPTH_CFG, AttentionPool2d,
                                               CLIPResNetBackbone, Res5Head)
from coin_tpu_torch.models.detector import TEXT_DIMS
from coin_tpu_torch.models.layers import Conv2d
from coin_tpu_torch.ops.roi_align import roi_align_batched


def _unit(x: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / norm.clamp_min(1e-8)


class CLIPScorer(nn.Module):
    """The backbone and res5 compute in ``compute_dtype`` over f32
    parameters; the attention pool and everything after it in f32."""

    def __init__(self, depth: int = 50,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = DEPTH_CFG[depth]
        self.compute_dtype = compute_dtype
        self.backbone = CLIPResNetBackbone(depth)
        self.res5 = Res5Head(depth)
        self.attnpool = AttentionPool2d(cfg["width"] * 32, cfg["heads"],
                                        TEXT_DIMS[depth])
        for m in (*self.backbone.modules(), *self.res5.modules()):
            if isinstance(m, Conv2d):
                m.compute_dtype = compute_dtype

    def forward(self, images: torch.Tensor, boxes: torch.Tensor,
                text_features: torch.Tensor, logit_scale) -> torch.Tensor:
        """images (B, H, W, 3) CLIP-normalised; boxes (B, N, 4) image
        coordinates; text_features (C+1, D) → softmax probs (B, N, C+1)."""
        feats = self.backbone(images, self.compute_dtype)
        x = roi_align_batched(feats, boxes, 1.0 / 16.0, 14, 2)
        b, n = x.shape[:2]
        x = self.res5(x.reshape((b * n,) + x.shape[2:]))
        region = self.attnpool(x).reshape(b, n, -1)
        scale = torch.exp(torch.as_tensor(logit_scale, dtype=torch.float32,
                                          device=region.device))
        logits = scale * torch.einsum("bnd,cd->bnc", _unit(region.float()),
                                      _unit(text_features.float()))
        return torch.softmax(logits, dim=-1)
