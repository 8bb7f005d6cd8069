"""Launcher of K8, the modulated deformable 3×3 convolution
(csrc/deform_conv.cu): 3×TF32 on Hopper's tensor cores, the kernel's
weights split into TF32 hi and lo parts by a launch of their own
(:func:`split_weights_cuda`; plain version :func:`split_weights_plain`),
which a caller with fixed weights makes once and passes in (``split``), as
``models/glip.Conv3x3Norm`` does. A call is then one launch, two where it
splits its sum (the reduce), one more where it splits the weights.

Counterpart of ``coin_tpu/models/glip.py:51`` ``deform_conv3x3``; the plain
PyTorch version and the GLIP modules are in
``coin_tpu_torch/models/glip.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from coin_tpu_torch.kernels.build import check, library

CIN_MULTIPLE, COUT_MULTIPLE = 32, 128
TILE = 128                     # output positions and channels per block


def _fn():
    fn = library("deform_conv").coin_deform_conv
    if fn.argtypes is None:            # the first call into this library
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _split_fn():
    fn = library("deform_conv").coin_deform_conv_split
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits_for(positions: int, cin: int, cout: int, sms: int) -> int:
    """Blocks per output tile: the least divisor of the 9 · Cin / 32
    (tap, channel chunk) steps that gives two blocks per SM, or the largest
    that leaves each block four steps (its pipeline's two stages, twice
    over). On GLIP-L's batch only P3 (722 tiles) does not split."""
    steps = 9 * cin // CIN_MULTIPLE
    tiles = -(-positions // TILE) * (cout // TILE)
    ds = [d for d in range(1, max(1, steps // 4) + 1) if steps % d == 0]
    return next((d for d in ds if tiles * d >= 2 * sms), ds[-1])


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as the kernel's ``cvt.rna.tf32.f32`` rounds a finite value."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_weights_plain(kernel: torch.Tensor):
    """Plain version of the kernel's weight split: kernel (3, 3, Cin,
    Cout) f32 → (hi, lo), each (9, Cout, Cin) f32 (input channels
    innermost, as wgmma reads them): hi = TF32(w), lo = TF32(w − hi), so
    that |w − (hi + lo)| ≤ 2⁻²² |w|."""
    w = kernel.reshape(9, kernel.shape[2], kernel.shape[3]).transpose(1, 2)
    w = w.contiguous().float()
    hi = _tf32(w)
    return hi, _tf32(w - hi)


def split_weights_cuda(kernel: torch.Tensor):
    """The weight split on the card, one launch: kernel (3, 3, Cin, Cout)
    f32 on a CUDA device → (hi, lo), equal to
    :func:`split_weights_plain`'s."""
    if not kernel.is_cuda or kernel.dtype != torch.float32 \
            or kernel.dim() != 4 or tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError(f"split_weights_cuda: a (3, 3, Cin, Cout) f32 CUDA "
                         f"kernel, got {tuple(kernel.shape)} {kernel.dtype} "
                         f"on {kernel.device}")
    cin, cout = kernel.shape[2:]
    w = kernel.contiguous()
    hi = torch.empty((9, cout, cin), dtype=torch.float32, device=w.device)
    lo = torch.empty_like(hi)
    err = _split_fn()(w.data_ptr(), hi.data_ptr(), lo.data_ptr(), cin, cout,
                      torch.cuda.current_stream(w.device).cuda_stream)
    check(err, "deform_conv weight split")
    split_weights_cuda.launches += 1
    return hi, lo


split_weights_cuda.launches = 0


def deform_conv_cuda(x: torch.Tensor, offsets: torch.Tensor,
                     mask: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor],
                     stride: int = 1, split=None) -> torch.Tensor:
    """x (B, H, W, Cin) f32 on a CUDA device, Cin a multiple of 32;
    offsets (B, Ho, Wo, 18) and mask (B, Ho, Wo, 9) f32; kernel
    (3, 3, Cin, Cout) f32 (HWIO), Cout a multiple of 128; bias (Cout,) f32
    or None; stride 1 or 2 → (B, Ho, Wo, Cout) f32. ``split``: the
    kernel's (hi, lo) from :func:`split_weights_cuda`, or None to split
    it here."""
    dev = x.device
    tensors = [x, offsets, mask, kernel] + ([] if bias is None else [bias])
    if not x.is_cuda or any(t.device != dev for t in tensors):
        raise ValueError("deform_conv_cuda: every tensor must be on one CUDA "
                         "device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("deform_conv_cuda: f32 only, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if x.dim() != 4 or offsets.dim() != 4 or mask.dim() != 4:
        raise ValueError(f"deform_conv_cuda: x {tuple(x.shape)}, offsets "
                         f"{tuple(offsets.shape)}, mask {tuple(mask.shape)}")
    b, h, w, cin = x.shape
    ho, wo = offsets.shape[1:3]
    cout = kernel.shape[-1]
    if (tuple(offsets.shape) != (b, ho, wo, 18)
            or tuple(mask.shape) != (b, ho, wo, 9)
            or tuple(kernel.shape) != (3, 3, cin, cout)
            or (bias is not None and tuple(bias.shape) != (cout,))
            or cin % CIN_MULTIPLE or cout % COUT_MULTIPLE
            or stride not in (1, 2)):
        raise ValueError(
            f"deform_conv_cuda: x {tuple(x.shape)}, offsets "
            f"{tuple(offsets.shape)}, mask {tuple(mask.shape)}, kernel "
            f"{tuple(kernel.shape)}, bias "
            f"{None if bias is None else tuple(bias.shape)}, stride {stride}"
            f" (Cin a multiple of {CIN_MULTIPLE}, Cout of {COUT_MULTIPLE}, "
            "stride 1 or 2)")
    x, offsets, mask = x.contiguous(), offsets.contiguous(), mask.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((b, ho, wo, cout), dtype=torch.float32, device=dev)
    if b * ho * wo == 0:
        return out
    splits = splits_for(b * ho * wo, cin, cout, _sm_count(dev.index))
    partial = (torch.empty((splits, b, ho, wo, cout), dtype=torch.float32,
                           device=dev) if splits > 1 else None)
    if split is None:
        split = split_weights_cuda(kernel)
    w_hi, w_lo = split
    if any(t.shape != (9, cout, cin) or t.dtype != torch.float32
           or t.device != dev or not t.is_contiguous() for t in split):
        raise ValueError("deform_conv_cuda: split must be (hi, lo), each a "
                         f"contiguous (9, {cout}, {cin}) f32 tensor on {dev}")
    if any(t is not None and t.data_ptr() % 16
           for t in (x, w_hi, w_lo, bias, out, partial)):
        raise ValueError("deform_conv_cuda: tensors not 16-byte aligned")
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _fn()(ptr(x), ptr(offsets), ptr(mask), ptr(w_hi), ptr(w_lo),
                ptr(bias), ptr(out), ptr(partial), b, h, w, cin, ho, wo,
                cout, stride, splits,
                torch.cuda.current_stream(dev).cuda_stream)
    check(err, "deform_conv")
    deform_conv_cuda.launches += 1
    return out


deform_conv_cuda.launches = 0
