"""CLIP ModifiedResNet backbone and res5 head (counterpart of
coin_tpu/models/clip_resnet.py:27-291).

3-conv stem with a trailing 2x2 average pool, anti-aliased strides (an
average pool before every stride-2 1x1 conv), frozen BatchNorm, C4 layout:
the backbone ends at res4; layer4 (res5) runs on the RoIAligned crops.
Public tensors are NHWC as in the JAX package; the convolutions run on
channels_last NCHW views of them, which is the same memory. Module and
parameter names follow the JAX parameter tree, so
``coin_tpu_torch.convert_from_jax`` maps it mechanically.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# channel/stride tables per depth (coin_tpu/models/clip_resnet.py:27-34)
DEPTH_CFG = {
    50: dict(layers=(3, 4, 6, 3), width=64, heads=32, out_dim=1024),
    101: dict(layers=(3, 4, 23, 3), width=64, heads=32, out_dim=512),
    200: dict(layers=(4, 6, 10, 6), width=80, heads=40, out_dim=640),
    800: dict(layers=(6, 8, 18, 8), width=96, heads=48, out_dim=768),
}


def conv(cin: int, cout: int, k: int, stride: int = 1,
         bias: bool = False) -> nn.Conv2d:
    """Conv with flax's explicit symmetric padding k // 2 (stride-2 stem
    conv included)."""
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=bias)


class FrozenBN(nn.Module):
    """y = x * (γ / √(var + ε)) + (β − mean · γ / √(var + ε)); the affine is
    formed in f32 and applied in the input's (compute) dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        mul = inv.to(x.dtype)
        add = (self.bias - self.running_mean * inv).to(x.dtype)
        return x * mul[:, None, None] + add[:, None, None]


class Bottleneck(nn.Module):
    """1x1 → 3x3 → (avgpool if stride > 1) → 1x1·4, plus the avgpool →
    1x1 downsample path."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = FrozenBN(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = FrozenBN(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = FrozenBN(planes * 4)
        self.has_downsample = stride > 1 or inplanes != planes * 4
        if self.has_downsample:
            self.downsample_conv = conv(inplanes, planes * 4, 1)
            self.downsample_bn = FrozenBN(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        if self.has_downsample:
            identity = F.avg_pool2d(x, self.stride) if self.stride > 1 else x
            identity = self.downsample_bn(self.downsample_conv(identity))
        else:
            identity = x
        return F.relu(out + identity)


def res_stage(inplanes: int, planes: int, blocks: int,
              stride: int = 1) -> nn.Sequential:
    """Unrolled stage; children are named "0", "1", ... as in the JAX
    tree."""
    layers = [Bottleneck(inplanes, planes, stride)]
    layers += [Bottleneck(planes * 4, planes) for _ in range(blocks - 1)]
    return nn.Sequential(*layers)


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class CLIPResNetBackbone(nn.Module):
    """Stem + layer1..layer3 → res4 (stride 16, width·16 channels)."""

    def __init__(self, depth: int = 50):
        super().__init__()
        cfg = DEPTH_CFG[depth]
        w, layers = cfg["width"], cfg["layers"]
        self.conv1 = conv(3, w // 2, 3, 2)
        self.bn1 = FrozenBN(w // 2)
        self.conv2 = conv(w // 2, w // 2, 3)
        self.bn2 = FrozenBN(w // 2)
        self.conv3 = conv(w // 2, w, 3)
        self.bn3 = FrozenBN(w)
        self.layer1 = res_stage(w, w, layers[0])
        self.layer2 = res_stage(w * 4, w * 2, layers[1], 2)
        self.layer3 = res_stage(w * 8, w * 4, layers[2], 2)

    def forward(self, images: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
        """images (B, H, W, 3) normalised → res4 (B, H/16, W/16, C4)."""
        x = _to_nchw(images.to(dtype))
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2)
        x = self.layer3(self.layer2(self.layer1(x)))
        return _to_nhwc(x)


class Res5Head(nn.Module):
    """layer4, applied to the RoIAligned res4 crops."""

    def __init__(self, depth: int = 50):
        super().__init__()
        cfg = DEPTH_CFG[depth]
        w = cfg["width"]
        self.layer4 = res_stage(w * 16, w * 8, cfg["layers"][3], 2)

    def forward(self, crops: torch.Tensor) -> torch.Tensor:
        """crops (N, r, r, C4) NHWC → (N, r/2, r/2, C5) NHWC."""
        return _to_nhwc(self.layer4(_to_nchw(crops)))
