"""Launchers of K2, the int8 training convolution, and K2s, the int8 serving
convolution: ``csrc/quantize.cu`` (dynamic quantisation of activations,
gradients and weights), ``csrc/qconv.cu`` (the s8 convolution with its
f32 rescale, written in f32 or bf16: a ``wgmma`` implicit GEMM for the K2
forward, the K2 dgrad and K2s, and a direct kernel for the stem's 3
channels) and ``csrc/qconv_wgrad.cu`` (the s8 weight gradient: a layout
pass and a ``wgmma`` GEMM).

Counterparts of ``coin_tpu/ops/qconv.py`` ``int8_train_conv`` (:136, with
``_vjp_fwd`` :158 and ``_vjp_bwd`` :170) and
``coin_tpu/models/clip_resnet.py:62`` ``Int8Conv``; the plain PyTorch
versions, the autograd function and the public functions are in
``coin_tpu_torch/ops/qconv.py``. Each launcher counts its launches; the
three users of the convolution kernel (forward, dgrad, serving) count
separately.
"""

from __future__ import annotations

import ctypes

import torch

from coin_tpu_torch.kernels.build import check, library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn(lib: str, name: str, argtypes):
    fn = getattr(library(lib), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{what}: every tensor must be on one CUDA device")


def quantize_cuda(x: torch.Tensor, per_sample: bool):
    """x (N, ...) f32 or bf16 on a CUDA device → (q int8 of x's shape,
    scale f32 of shape (N,) per sample or (1,) per tensor)."""
    _require_cuda("quantize_cuda", x)
    if x.dtype not in _DTYPES:
        raise TypeError(f"quantize_cuda: {x.dtype} (f32 or bf16)")
    x = x.contiguous()
    n = x.numel()
    nseg = x.shape[0] if per_sample else 1
    if n == 0 or n % nseg:
        raise ValueError(f"quantize_cuda: shape {tuple(x.shape)}")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((nseg,), dtype=torch.float32, device=x.device)
    amax = torch.empty((nseg,), dtype=torch.int32, device=x.device)
    err = _fn("quantize", "coin_quantize",
              [_P, _I, ctypes.c_longlong, ctypes.c_longlong, _I, _P, _P, _P,
               _P])(x.data_ptr(), _DTYPES[x.dtype], n, n // nseg, nseg,
                    q.data_ptr(), scale.data_ptr(), amax.data_ptr(),
                    _stream(x))
    check(err, "quantize")
    quantize_cuda.launches += 1
    return q, scale


quantize_cuda.launches = 0


def quantize_weight_cuda(w: torch.Tensor, per_input: bool):
    """w (O, I, k, k) f32 on a CUDA device → (wq, scale): per output
    channel, wq (O, k, k, I) and scale (O,); per input channel (the dgrad's
    weights), wq (I, k, k, O) of the spatially flipped kernel and scale
    (I,)."""
    _require_cuda("quantize_weight_cuda", w)
    if w.dtype != torch.float32 or w.dim() != 4 or w.shape[2] != w.shape[3]:
        raise TypeError(f"quantize_weight_cuda: {w.dtype} {tuple(w.shape)} "
                        f"(f32 (O, I, k, k))")
    w = w.contiguous()
    o, i, k, _ = w.shape
    rows, cols = (i, o) if per_input else (o, i)
    wq = torch.empty((rows, k, k, cols), dtype=torch.int8, device=w.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=w.device)
    err = _fn("quantize", "coin_quantize_weight",
              [_P, _I, _I, _I, _I, _P, _P, _P])(
        w.data_ptr(), o, i, k, int(per_input), wq.data_ptr(),
        scale.data_ptr(), _stream(w))
    check(err, "quantize_weight")
    quantize_weight_cuda.launches += 1
    return wq, scale


quantize_weight_cuda.launches = 0


def _qconv(what: str, xq: torch.Tensor, wq: torch.Tensor,
           row_scale: torch.Tensor, col_scale: torch.Tensor, stride: int,
           pad: int, out_dtype: torch.dtype) -> torch.Tensor:
    _require_cuda(what, xq, wq, row_scale, col_scale)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"{what}: operands {xq.dtype}, {wq.dtype} (int8)")
    if out_dtype not in _DTYPES:
        raise TypeError(f"{what}: output {out_dtype} (f32 or bf16)")
    n, h, w, c = xq.shape
    o, k, k2, c2 = wq.shape
    if (k != k2 or c != c2 or row_scale.numel() not in (1, n)
            or col_scale.numel() != o):
        raise ValueError(f"{what}: shapes {tuple(xq.shape)}, "
                         f"{tuple(wq.shape)}, scales {row_scale.numel()}, "
                         f"{col_scale.numel()}")
    xq, wq = xq.contiguous(), wq.contiguous()
    row_scale = row_scale.float().contiguous()
    col_scale = col_scale.float().contiguous()
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    out = torch.empty((n, ho, wo, o), dtype=out_dtype, device=xq.device)
    err = _fn("qconv", "coin_qconv",
              [_P] * 5 + [_I] * 10 + [_P])(
        xq.data_ptr(), wq.data_ptr(), row_scale.data_ptr(),
        col_scale.data_ptr(), out.data_ptr(), n, h, w, c, o, k, stride, pad,
        int(row_scale.numel() > 1), _DTYPES[out_dtype], _stream(xq))
    check(err, what)
    return out


def qconv_fwd_cuda(xq, wq, row_scale, col_scale, stride: int, pad: int,
                   out_dtype: torch.dtype = torch.float32):
    """K2 forward: xq (N, H, W, C) s8, wq (O, k, k, C) s8, row_scale (1,)
    or (N,), col_scale (O,) → (N, Ho, Wo, O) in ``out_dtype`` (f32 or
    bf16) = f32(acc) * (row_scale * col_scale), rounded to it."""
    out = _qconv("qconv_fwd", xq, wq, row_scale, col_scale, stride, pad,
                 out_dtype)
    qconv_fwd_cuda.launches += 1
    return out


qconv_fwd_cuda.launches = 0


def qconv_dgrad_cuda(gq, wt, row_scale, col_scale, pad: int,
                     out_dtype: torch.dtype = torch.float32):
    """K2 dgrad: the gradient's s8 (N, H, W, O) against the flipped,
    per-input-channel weights (I, k, k, O) → (N, H, W, I) in
    ``out_dtype``."""
    out = _qconv("qconv_dgrad", gq, wt, row_scale, col_scale, 1, pad,
                 out_dtype)
    qconv_dgrad_cuda.launches += 1
    return out


qconv_dgrad_cuda.launches = 0


def int8_conv_cuda(xq, wq, row_scale, col_scale, stride: int, pad: int,
                   out_dtype: torch.dtype = torch.float32):
    """K2s, the serving convolution (any stride, the stem's 3 input
    channels included): the same function as :func:`qconv_fwd_cuda`."""
    out = _qconv("int8_conv", xq, wq, row_scale, col_scale, stride, pad,
                 out_dtype)
    int8_conv_cuda.launches += 1
    return out


int8_conv_cuda.launches = 0


def wgrad_layout_cuda(q: torch.Tensor, k: int) -> torch.Tensor:
    """The layout pass of K2 wgrad: q (N, H, W, C) s8 → (C, Pp) s8,
    channel-major over the padded grid of positions of
    ``ops/qconv.wgrad_layout_plain`` (the same bytes)."""
    from coin_tpu_torch.ops.qconv import wgrad_positions
    _require_cuda("wgrad_layout_cuda", q)
    if q.dtype != torch.int8 or q.dim() != 4 or q.shape[-1] % 4:
        raise ValueError(f"wgrad_layout_cuda: {q.dtype} {tuple(q.shape)} "
                         f"(s8 (N, H, W, C), C a multiple of 4)")
    q = q.contiguous()
    n, h, w, c = q.shape
    pp = wgrad_positions(n, h, w, k)
    out = torch.empty((c, pp), dtype=torch.int8, device=q.device)
    err = _fn("qconv_wgrad", "coin_qconv_wgrad_layout",
              [_P, _P] + [_I] * 5 + [_P])(
        q.data_ptr(), out.data_ptr(), n, h, w, c, k, _stream(q))
    check(err, "qconv_wgrad_layout")
    return out


def qconv_wgrad_cuda(xq: torch.Tensor, gq: torch.Tensor, xs: torch.Tensor,
                     gs: torch.Tensor, k: int) -> torch.Tensor:
    """K2 wgrad: xq (N, H, W, I) and gq (N, H, W, O) s8 of a stride-1
    'same' conv, xs and gs one f32 each → dw (O, I, k, k) f32 =
    f32(s32 sum, wrapping) * (xs * gs). The layout pass writes both
    operands channel-major over the padded grid, then the wgmma GEMM sums
    each tap as a shifted product and a last pass adds its splits and
    rescales."""
    _require_cuda("qconv_wgrad_cuda", xq, gq, xs, gs)
    if xq.dtype != torch.int8 or gq.dtype != torch.int8:
        raise TypeError(f"qconv_wgrad_cuda: {xq.dtype}, {gq.dtype} (int8)")
    n, h, w, i = xq.shape
    o = gq.shape[-1]
    if (gq.shape[:3] != xq.shape[:3] or xs.numel() != 1 or gs.numel() != 1
            or i % 4 or o % 4):
        raise ValueError(f"qconv_wgrad_cuda: shapes {tuple(xq.shape)}, "
                         f"{tuple(gq.shape)} (channels multiples of 4), "
                         f"scales {xs.numel()}, {gs.numel()}")
    xt = wgrad_layout_cuda(xq, k)
    gt = wgrad_layout_cuda(gq, k)
    xs, gs = xs.float().contiguous(), gs.float().contiguous()
    splits = _fn("qconv_wgrad", "coin_qconv_wgrad_splits", [_I] * 6)(
        n, h, w, i, o, k)
    part = torch.empty((splits, k * k, o, i), dtype=torch.int32,
                       device=xq.device)
    dw = torch.empty((o, i, k, k), dtype=torch.float32, device=xq.device)
    err = _fn("qconv_wgrad", "coin_qconv_wgrad", [_P] * 6 + [_I] * 7 + [_P])(
        xt.data_ptr(), gt.data_ptr(), xs.data_ptr(), gs.data_ptr(),
        part.data_ptr(), dw.data_ptr(), n, h, w, i, o, k, splits,
        _stream(xq))
    check(err, "qconv_wgrad")
    qconv_wgrad_cuda.launches += 1
    return dw


qconv_wgrad_cuda.launches = 0
