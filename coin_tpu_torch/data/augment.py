"""The strong and weak views, and input normalisation (counterpart of
coin_tpu/data/augment.py:23-125: ``preprocess_batch`` and
``normalize_batch``).

On a CUDA tensor ``preprocess_batch`` runs kernel K4 (csrc/augment.cu,
launched by kernels/augment.py) and ``normalize_batch`` kernel K4n
(csrc/normalize.cu); on a CPU tensor they run :func:`preprocess_plain` and
:func:`normalize_plain`.

The JAX package draws the strong view's random values inside the function
from a key; here they come in as a tensor ``draws`` (B, 9) per image:
the four gate uniforms (jitter p=0.8, gray p=0.2, blur p=0.5, solarize
p=0.2), brightness, contrast and saturation factors in [0.6, 1.4), the hue
mix in [-0.1, 0.1) and the blur σ in [0.1, 2). :func:`draw_augment` draws
them from an explicit generator; a test hands in JAX's values.
"""

from __future__ import annotations

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IDENTITY_MEAN, IDENTITY_STD = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
GRAY = (0.299, 0.587, 0.114)
GATE_P = (0.8, 0.2, 0.5, 0.2)
BLUR_RADIUS = 4
NUM_PARAMS = 20     # per image, the layout of csrc/augment.cu


def _div(a: torch.Tensor, d) -> torch.Tensor:
    """a / d correctly rounded on every device (PyTorch's CUDA kernels
    multiply by the reciprocal of a scalar divisor)."""
    return a / torch.as_tensor(d, dtype=a.dtype, device=a.device) \
        .expand_as(a)


def normalize_plain(images_u8: torch.Tensor, mean=CLIP_MEAN,
                    std=CLIP_STD) -> torch.Tensor:
    """Plain version of K4n: uint8 (..., 3) → (x / 255 - mean) / std, f32."""
    mean = torch.tensor(mean, device=images_u8.device)
    std = torch.tensor(std, device=images_u8.device)
    return (_div(images_u8.float(), 255.0) - mean) / std


def normalize_batch(images_u8: torch.Tensor, mean=CLIP_MEAN,
                    std=CLIP_STD) -> torch.Tensor:
    """uint8 (B, H, W, 3) NHWC → float32 (B, H, W, 3) normalised with the
    per-channel ``mean`` and ``std`` (CLIP's unless given; the GDINO teacher
    passes ImageNet's)."""
    if images_u8.is_cuda:
        from coin_tpu_torch.kernels.normalize import normalize_cuda
        return normalize_cuda(images_u8, mean, std)
    return normalize_plain(images_u8, mean, std)


def draw_augment(generator: torch.Generator, batch: int) -> torch.Tensor:
    """(batch, 9) draws on the generator's device with the distributions
    of coin_tpu/data/augment.py:29-101."""
    u = torch.rand((batch, 9), generator=generator, device=generator.device)
    lo = torch.tensor([0, 0, 0, 0, 0.6, 0.6, 0.6, -0.1, 0.1], device=u.device)
    hi = torch.tensor([1, 1, 1, 1, 1.4, 1.4, 1.4, 0.1, 2.0], device=u.device)
    return lo + u * (hi - lo)


def blur_taps(sigma: torch.Tensor) -> torch.Tensor:
    """(B,) σ → (B, 9) normalised Gaussian taps at offsets -4..4."""
    x = torch.arange(-BLUR_RADIUS, BLUR_RADIUS + 1, dtype=torch.float32,
                     device=sigma.device)
    z = x[None] / sigma[:, None]
    k = torch.exp(-0.5 * (z * z))
    return k / k.sum(-1, keepdim=True)


def augment_params(draws: torch.Tensor) -> torch.Tensor:
    """(B, 9) draws → the (B, 20) per-image parameters both versions read:
    gates as 1/0, b, c, s, hue, the 9 blur taps, 3 unused."""
    gates = (draws[:, :4] < torch.tensor(GATE_P, device=draws.device)).float()
    pad = torch.zeros((draws.shape[0], 3), device=draws.device)
    return torch.cat([gates, draws[:, 4:8].float(),
                      blur_taps(draws[:, 8].float()), pad], 1).contiguous()


def _gray(v: torch.Tensor) -> torch.Tensor:
    return v[..., 0] * GRAY[0] + v[..., 1] * GRAY[1] + v[..., 2] * GRAY[2]


def _shifted_sum(x: torch.Tensor, taps: torch.Tensor, dim: int):
    """Σ_t taps[:, t] · x shifted by t - 4 along ``dim`` (1 = rows, 2 =
    columns), zero outside the canvas, summed in the order t = 0..8."""
    size = x.shape[dim]
    out = torch.zeros_like(x)
    for t in range(2 * BLUR_RADIUS + 1):
        d = t - BLUR_RADIUS
        lo, hi = max(0, -d), min(size, size - d)
        if lo >= hi:
            continue
        k = taps[:, t].reshape(-1, 1, 1, 1)
        src = x.narrow(dim, lo + d, hi - lo)
        dst = out.narrow(dim, lo, hi - lo)
        dst.copy_(dst + k * src)
    return out


def preprocess_plain(images_u8: torch.Tensor, params: torch.Tensor,
                     weak: bool = True, mean=CLIP_MEAN, std=CLIP_STD):
    """Plain version of K4: uint8 (B, H, W, 3), params (B, 20) →
    (strong, weak), each float32 (B, H, W, 3) normalised with ``mean`` and
    ``std`` (CLIP's unless given); weak is None when ``weak`` is false."""
    dev = images_u8.device
    mean_c = torch.tensor(mean, device=dev)
    std_c = torch.tensor(std, device=dev)
    img = _div(images_u8.float(), 255.0)
    weak_view = _div(img - mean_c, std_c) if weak else None
    col = lambda i: params[:, i].reshape(-1, 1, 1, 1)
    on = lambda i: params[:, i].reshape(-1, 1, 1, 1) != 0

    # colour jitter: brightness, contrast around the canvas's mean gray,
    # saturation around the pixel's gray, hue, one clip
    v = img * col(4)
    gray_mean = (_gray(v).double().sum((1, 2))
                 / (v.shape[1] * v.shape[2])).float().reshape(-1, 1, 1, 1)
    v = (v - gray_mean) * col(5) + gray_mean
    g = _gray(v)[..., None]
    v = (v - g) * col(6) + g
    v = v + col(7) * (torch.roll(v, 1, dims=-1) - v)
    x = torch.where(on(0), v.clamp(0.0, 1.0), img)
    x = torch.where(on(1), _gray(x)[..., None].expand_as(x), x)
    taps = params[:, 8:17]
    blurred = _shifted_sum(_shifted_sum(x, taps, 1), taps, 2)
    x = torch.where(on(2), blurred, x)
    x = torch.where(on(3) & (x >= 0.5), 1.0 - x, x)
    return _div(x - mean_c, std_c), weak_view


def preprocess_batch(images_u8: torch.Tensor, draws: torch.Tensor,
                     weak: bool = True, mean=CLIP_MEAN, std=CLIP_STD):
    """uint8 (B, H, W, 3) and draws (B, 9) → (strong, weak) views, each
    float32 (B, H, W, 3) normalised with ``mean`` and ``std`` (CLIP's
    unless given). With ``weak`` false the weak view is not computed and
    comes back as None, as the compiled JAX step never computes the view
    that its cached flavours drop. The horizontal flip happens on the
    host, in the loader, as in the JAX package."""
    params = augment_params(draws.to(images_u8.device))
    if images_u8.is_cuda:
        from coin_tpu_torch.kernels.augment import augment_cuda
        return augment_cuda(images_u8, params, mean, std, weak)
    return preprocess_plain(images_u8, params, weak, mean, std)


def strong_view_u8(images_u8: torch.Tensor, draws: torch.Tensor
                   ) -> torch.Tensor:
    """The collection's AUG view (coin_tpu/engine/collect.py:93-97): the
    strong view of uint8 (B, H, W, 3) under draws (B, 9), from K4 with the
    identity normalisation (mean 0, std 1, so ``(x - 0) / 1`` is ``x``),
    times 255 and cast to uint8. The cast truncates as JAX's does: an
    untouched pixel ``v`` comes back as ``v - 1`` wherever ``v / 255 *
    255`` rounds below ``v`` in f32."""
    strong, _ = preprocess_batch(images_u8, draws, weak=False,
                                 mean=IDENTITY_MEAN, std=IDENTITY_STD)
    return (strong * 255.0).to(torch.uint8)
