"""Launcher of K8, the modulated deformable 3×3 convolution
(csrc/deform_conv.cu).

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
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits_for(positions: int, cin: int, cout: int, sms: int) -> int:
    """Blocks per output tile: the least divisor of the 9 · Cin / 32
    (tap, channel chunk) steps that gives two blocks per SM, or all steps.
    Only the coarse levels split; P3 (722 tiles on GLIP-L's batch) does
    not."""
    steps = 9 * cin // CIN_MULTIPLE
    tiles = -(-positions // TILE) * (cout // TILE)
    return next(d for d in range(1, steps + 1)
                if steps % d == 0 and (tiles * d >= 2 * sms or d == steps))


def deform_conv_cuda(x: torch.Tensor, offsets: torch.Tensor,
                     mask: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor],
                     stride: int = 1) -> torch.Tensor:
    """x (B, H, W, Cin) f32 on a CUDA device, Cin a multiple of 32;
    offsets (B, Ho, Wo, 18) and mask (B, Ho, Wo, 9) f32; kernel
    (3, 3, Cin, Cout) f32 (HWIO), Cout a multiple of 128; bias (Cout,) f32
    or None; stride 1 or 2 → (B, Ho, Wo, Cout) f32."""
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
    weight = kernel.reshape(9, cin, cout).contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((b, ho, wo, cout), dtype=torch.float32, device=dev)
    if b * ho * wo == 0:
        return out
    splits = splits_for(b * ho * wo, cin, cout, _sm_count(dev.index))
    partial = (torch.empty((splits, b, ho, wo, cout), dtype=torch.float32,
                           device=dev) if splits > 1 else None)
    if any(t is not None and t.data_ptr() % 16
           for t in (x, weight, bias, out, partial)):
        raise ValueError("deform_conv_cuda: tensors not 16-byte aligned")
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _fn()(ptr(x), ptr(offsets), ptr(mask), ptr(weight), ptr(bias),
                ptr(out), ptr(partial), b, h, w, cin, ho, wo, cout, stride,
                splits, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "deform_conv")
    deform_conv_cuda.launches += 1
    return out


deform_conv_cuda.launches = 0
