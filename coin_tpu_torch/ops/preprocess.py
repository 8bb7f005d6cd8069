"""Device-side image preprocessing (counterpart of
coin_tpu/ops/preprocess.py): kernel K10.

- ``resize_bilinear`` (K10a): the aspect-preserving PIL-style bilinear
  resize into the top-left of a static canvas, zeros past the scaled
  extent. The plain version is the JAX function's dense form, two
  interpolation-matrix contractions (rows, then columns); the kernel
  (csrc/preprocess.cu) computes each output's few non-zero taps directly
  in the same two passes.
- ``normalize_flip`` (K10b): u8 → /255 → a per-image horizontal flip →
  (x − mean) / std, with mean and std as arguments.

As in the JAX package neither is on the training or eval path: the host
loader resizes and flips (``data/loader.py``). The port's
``tools/bench_preprocess`` times them. Each public function launches its
kernel on a CUDA tensor and runs the plain version on a CPU tensor.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from coin_tpu_torch.data.augment import _div


def _scale_f32(scale) -> torch.Tensor:
    return torch.as_tensor(scale, dtype=torch.float32).reshape(())


def scaled_extent(src: int, scale) -> int:
    """``round(src · scale)`` as JAX computes it: the product in f32,
    rounded half to even."""
    return int(np.rint(np.float32(src) * np.float32(_scale_f32(scale))))


def resize_matrix(src: int, dst: int, scale, device="cpu") -> torch.Tensor:
    """(dst, src) PIL-BILINEAR weights (``_resize_matrix``): half-pixel
    centres clamped to [0, src − 1], the tent widened by 1/scale on a
    downscale, each row divided by max(its sum, 1e-8). All in f32."""
    s = _scale_f32(scale).to(device)
    pos = _div(torch.arange(dst, dtype=torch.float32, device=device) + 0.5,
               s) - 0.5
    pos = pos.clamp(0.0, float(src - 1))
    support = torch.clamp_min(_div(torch.ones((), device=device), s), 1.0)
    grid = torch.arange(src, dtype=torch.float32, device=device)
    dist = (pos[:, None] - grid[None, :]).abs()
    tent = (1.0 - _div(dist, support)).clamp_min(0.0)
    norm = tent.sum(dim=1, keepdim=True).clamp_min(1e-8)
    return tent / norm.expand_as(tent)


def resize_bilinear_plain(image: torch.Tensor, scale,
                          out_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain version of K10a: image (H0, W0, 3) u8 or f32 → (H1, W1, 3)
    f32, as two dense contractions in JAX's order (rows, then columns)."""
    h0, w0, _ = image.shape
    h1, w1 = out_hw
    dev = image.device
    ay = resize_matrix(h0, h1, scale, dev)                  # (H1, H0)
    ax = resize_matrix(w0, w1, scale, dev)                  # (W1, W0)
    img = image.float()
    tmp = torch.einsum("yh,hwc->ywc", ay, img)
    out = torch.einsum("ywc,xw->yxc", tmp, ax)
    ys = torch.arange(h1, device=dev)[:, None, None]
    xs = torch.arange(w1, device=dev)[None, :, None]
    valid = (ys < scaled_extent(h0, scale)) & (xs < scaled_extent(w0, scale))
    return torch.where(valid, out, torch.zeros((), device=dev))


def resize_bilinear(image: torch.Tensor, scale,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """image (H0, W0, 3) uint8 or float → (H1, W1, 3) float32, scaled by
    ``scale`` into the top-left corner of the (H1, W1) canvas (K10a on a
    CUDA tensor)."""
    if image.is_cuda:
        from coin_tpu_torch.kernels.preprocess import resize_bilinear_cuda
        return resize_bilinear_cuda(image, scale, out_hw)
    return resize_bilinear_plain(image, scale, out_hw)


def normalize_flip_plain(images_u8: torch.Tensor, flip: torch.Tensor,
                         mean: Sequence[float], std: Sequence[float]
                         ) -> torch.Tensor:
    """Plain version of K10b: (B, H, W, 3) u8 and (B,) flags →
    ((x / 255, mirrored where flagged) − mean) / std in f32."""
    dev = images_u8.device
    img = _div(images_u8.float(), 255.0)
    img = torch.where(flip.to(dev).bool()[:, None, None, None],
                      img.flip(2), img)
    mean = torch.tensor(mean, dtype=torch.float32, device=dev)
    std = torch.tensor(std, dtype=torch.float32, device=dev)
    return (img - mean) / std


def normalize_flip(images_u8: torch.Tensor, flip: Union[torch.Tensor,
                                                        Sequence[bool]],
                   mean: Sequence[float], std: Sequence[float]
                   ) -> torch.Tensor:
    """(B, H, W, 3) uint8 + (B,) flip flags → normalised float32 (K10b on
    a CUDA tensor)."""
    flip = torch.as_tensor(flip, dtype=torch.bool, device=images_u8.device)
    if images_u8.is_cuda:
        from coin_tpu_torch.kernels.preprocess import normalize_flip_cuda
        return normalize_flip_cuda(images_u8, flip, mean, std)
    return normalize_flip_plain(images_u8, flip, mean, std)
