"""Input normalisation (counterpart of coin_tpu/data/augment.py:23-24 and
:122-125, ``normalize_batch``).

On a CUDA tensor it runs kernel K4n (csrc/normalize.cu, launched by
kernels/normalize.py); on a CPU tensor it runs :func:`normalize_plain`.
"""

from __future__ import annotations

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_plain(images_u8: torch.Tensor) -> torch.Tensor:
    """Plain version of K4n: uint8 (..., 3) → (x / 255 - mean) / std, f32."""
    mean = torch.tensor(CLIP_MEAN, device=images_u8.device)
    std = torch.tensor(CLIP_STD, device=images_u8.device)
    return (images_u8.float() / 255.0 - mean) / std


def normalize_batch(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) NHWC → CLIP-normalised float32 (B, H, W, 3)."""
    if images_u8.is_cuda:
        from coin_tpu_torch.kernels.normalize import normalize_cuda
        return normalize_cuda(images_u8, CLIP_MEAN, CLIP_STD)
    return normalize_plain(images_u8)
