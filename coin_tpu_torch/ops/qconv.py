"""Dynamic-int8 convolutions (counterpart of coin_tpu/ops/qconv.py and of
``Int8Conv``'s arithmetic, coin_tpu/models/clip_resnet.py:62-92).

``int8_train_conv`` (K2) is the training conv of ``TPU.INT8_TRAIN``: the
forward quantises the activation (one scale per tensor, or per sample) and
the f32 master weight (one scale per output channel) to s8, accumulates in
s32 and rescales to f32; the backward quantises the incoming gradient the
same way against the weight requantised per input channel, flipped and
transposed (dgrad), and takes the weight gradient either in s8 x s8 with
per-tensor scales from the saved s8 activation (mode ``qt=1``) or exactly
in the activation's dtype. ``int8_conv`` (K2s) is the serving forward.

On a CUDA tensor each step runs a kernel (``kernels/qconv.py``); on a CPU
tensor its plain version here. The plain versions compute the integer sums
exactly (an f64 convolution of the s8 values: every partial sum is an
integer below 2**53), wrap them to s32 as XLA's accumulator does, and
apply the rescale in the kernel's order. Every step is the IEEE operation
the JAX source writes, in its order: the scale is max(amax, 1e-12) / 127,
correctly rounded. (Under ``jit`` XLA rewrites that division into a product
with the reciprocal and reassociates the constants of the rescale, rewrites
that depend on the surrounding graph; the port does not chase them.) Tensors
are NHWC at these functions, as in the JAX package; weights are the port's
(O, I, k, k).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127, divided by a tensor: PyTorch's CUDA kernels
    multiply by the reciprocal of a scalar divisor."""
    return amax.clamp_min(1e-12) / torch.full_like(amax, 127.0)


def _s8(r: torch.Tensor) -> torch.Tensor:
    """Rounded values to s8, a NaN (from a NaN scale) to 0 as XLA's
    convert gives it."""
    return r.nan_to_num(0.0).to(torch.int8)


def _quant(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return _s8(torch.round(v / s).clamp(-127, 127))


def quantize_plain(x: torch.Tensor, per_sample: bool = False):
    """Plain version of the activation quantisation (qconv.py:63-80):
    (q int8 of x's shape, scale f32 (N,) per sample or (1,) per tensor)."""
    xf = x.float()
    if per_sample:
        s = _scale(xf.abs().flatten(1).amax(1))
        view = s.reshape((-1,) + (1,) * (x.dim() - 1))
    else:
        s = _scale(xf.abs().amax().reshape(1))
        view = s
    return _quant(xf, view), s


def quantize_weight_plain(w: torch.Tensor, per_input: bool = False):
    """Plain version of the weight quantisation: w (O, I, k, k) f32 →
    per output channel (qconv.py:92-93) wq (O, k, k, I) and scale (O,); per
    input channel (:190-193) wq (I, k, k, O) of the flipped kernel, the
    weights of the dgrad conv, and scale (I,). No clip, as in JAX."""
    w = w.float()
    if per_input:
        s = _scale(w.abs().amax(dim=(0, 2, 3)))
        q = _s8(torch.round(w / s[None, :, None, None]))
        return q.flip(2, 3).permute(1, 2, 3, 0).contiguous(), s
    s = _scale(w.abs().amax(dim=(1, 2, 3)))
    q = _s8(torch.round(w / s[:, None, None, None]))
    return q.permute(0, 2, 3, 1).contiguous(), s


# f32 holds every integer below 2**24 exactly, so an f32 convolution of s8
# values is exact while no partial sum can pass it: K terms of at most
# 15 * 127 after splitting one operand into 16 * hi + lo
_F32_TERMS = 2 ** 24 // (15 * 127)


def _exact_sum(conv, a: torch.Tensor, b: torch.Tensor, terms: int):
    """``conv(a, b)`` of two s8 tensors as exact integers in f64. On the
    card one f64 convolution; on the CPU, where f64 convolutions are slow,
    two f32 ones over a = 16 * hi + lo (``terms`` bounds the number of
    products in one sum)."""
    if a.is_cuda or terms > _F32_TERMS:
        return conv(a.double(), b.double())
    a = a.to(torch.int16)
    hi = torch.div(a, 16, rounding_mode="floor")
    lo = a - 16 * hi
    b = b.float()
    return (16 * conv(hi.float(), b).double()
            + conv(lo.float(), b).double())


def _wrap_s32(acc: torch.Tensor) -> torch.Tensor:
    """Exact integer sums (f64) → the s32 XLA's accumulator holds."""
    if bool((acc.abs() < 2 ** 31).all()):
        return acc.to(torch.int32)
    v = acc.to(torch.int64)
    return (torch.remainder(v + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def _rescale(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return acc.to(torch.float32) * (a * b)


def qconv_plain(xq: torch.Tensor, wq: torch.Tensor, row_scale: torch.Tensor,
                col_scale: torch.Tensor, stride: int, pad: int
                ) -> torch.Tensor:
    """Plain version of the s8 convolution: xq (N, H, W, C), wq
    (O, k, k, C) → (N, Ho, Wo, O) f32 = f32(s32 sum) * (row_scale *
    col_scale), row_scale (1,) or (N,)."""
    conv = lambda a, b: F.conv2d(a, b, stride=stride, padding=pad)
    acc = _exact_sum(conv, xq.permute(0, 3, 1, 2), wq.permute(0, 3, 1, 2),
                     wq[0].numel()).permute(0, 2, 3, 1)
    rs = row_scale.float().reshape(-1, 1, 1, 1)
    return _rescale(_wrap_s32(acc), rs, col_scale.float())


def qconv_wgrad_s32_plain(xq: torch.Tensor, gq: torch.Tensor,
                          k: int) -> torch.Tensor:
    """The s32 sums of the s8 weight gradient of a stride-1 'same' conv:
    xq (N, H, W, I), gq (N, H, W, O) → (O, I, k, k) int32, wrapped."""
    shape = (gq.shape[-1], xq.shape[-1], k, k)
    conv = lambda a, b: torch.nn.grad.conv2d_weight(a, shape, b, stride=1,
                                                    padding=k // 2)
    x, g = xq.permute(0, 3, 1, 2), gq.permute(0, 3, 1, 2)
    per = max(_F32_TERMS // (x.shape[2] * x.shape[3]), 1)  # samples a sum
    acc = sum(_exact_sum(conv, x[i:i + per], g[i:i + per],
                         per * x.shape[2] * x.shape[3])
              for i in range(0, x.shape[0], per))
    return _wrap_s32(acc)


def qconv_wgrad_plain(xq: torch.Tensor, gq: torch.Tensor, xs: torch.Tensor,
                      gs: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of the s8 weight gradient of a stride-1 'same' conv:
    xq (N, H, W, I), gq (N, H, W, O) → dw (O, I, k, k) f32."""
    return _rescale(qconv_wgrad_s32_plain(xq, gq, k), xs.float().reshape(()),
                    gs.float().reshape(()))


# ----------------------------------------------------------- dispatch
def quantize(x: torch.Tensor, per_sample: bool = False):
    if x.is_cuda:
        from coin_tpu_torch.kernels.qconv import quantize_cuda
        return quantize_cuda(x, per_sample)
    return quantize_plain(x, per_sample)


def quantize_weight(w: torch.Tensor, per_input: bool = False):
    if w.is_cuda:
        from coin_tpu_torch.kernels.qconv import quantize_weight_cuda
        return quantize_weight_cuda(w, per_input)
    return quantize_weight_plain(w, per_input)


def _fwd_parts(x: torch.Tensor, w: torch.Tensor, stride: int,
               per_sample: bool):
    """Quantised forward (qconv.py:83-98): (f32 output, xq, xs)."""
    k = w.shape[-1]
    xq, xs = quantize(x, per_sample)
    wq, ks = quantize_weight(w)
    if x.is_cuda:
        from coin_tpu_torch.kernels.qconv import qconv_fwd_cuda
        out = qconv_fwd_cuda(xq, wq, xs, ks, stride, k // 2)
    else:
        out = qconv_plain(xq, wq, xs, ks, stride, k // 2)
    return out, xq, xs


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


class Int8TrainConv(torch.autograd.Function):
    """The custom VJP of coin_tpu/ops/qconv.py:135-215."""

    @staticmethod
    def forward(ctx, x, w, stride, wgrad_int8, per_sample, dgrad_int8):
        int8_res = wgrad_int8 and dgrad_int8 and stride == 1 \
            and not per_sample
        out, xq, xs = _fwd_parts(x, w, stride, per_sample)
        ctx.meta = (stride, wgrad_int8, per_sample, dgrad_int8, int8_res,
                    x.dtype, tuple(x.shape))
        # mode 1 keeps the s8 activation and its scale, not x: half the
        # bytes of a bf16 activation, and no requantisation in the backward
        ctx.save_for_backward(*((xq, xs, w) if int8_res else (x, w)))
        return out

    @staticmethod
    def backward(ctx, g):
        stride, wgrad_int8, per_sample, dgrad_int8, int8_res, x_dtype, \
            x_shape = ctx.meta
        if int8_res:
            xq, xs, w = ctx.saved_tensors
            x = None
        else:
            x, w = ctx.saved_tensors
        k = w.shape[-1]
        p = k // 2
        g = g.contiguous()
        dx = dw = None
        gq = gs = None
        if stride == 1 and dgrad_int8:
            gq, gs = quantize(g.float(), per_sample)
            wt, ks_i = quantize_weight(w, per_input=True)
            if g.is_cuda:
                from coin_tpu_torch.kernels.qconv import qconv_dgrad_cuda
                dx = qconv_dgrad_cuda(gq, wt, gs, ks_i, p)
            else:
                dx = qconv_plain(gq, wt, gs, ks_i, 1, p)
            dx = dx.to(x_dtype)
        else:
            dx = _nhwc(torch.nn.grad.conv2d_input(
                (x_shape[0], x_shape[3], x_shape[1], x_shape[2]),
                w.to(x_dtype), _nchw(g.to(x_dtype)), stride=stride,
                padding=p))
        if int8_res:
            if g.is_cuda:
                from coin_tpu_torch.kernels.qconv import qconv_wgrad_cuda
                dw = qconv_wgrad_cuda(xq, gq, xs, gs, k)
            else:
                dw = qconv_wgrad_plain(xq, gq, xs, gs, k)
        else:
            dw = torch.nn.grad.conv2d_weight(
                _nchw(x), tuple(w.shape), _nchw(g.to(x.dtype)),
                stride=stride, padding=p)
        return dx, dw.to(w.dtype), None, None, None, None


def int8_train_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                    wgrad_int8: bool = False, per_sample: bool = False,
                    dgrad_int8: bool = True) -> torch.Tensor:
    """x (N, H, W, I) in the compute dtype, w (O, I, k, k) the f32 master
    weight → (N, Ho, Wo, O) f32; padding k // 2. Gradients: dx in x's
    dtype, dw in w's."""
    return Int8TrainConv.apply(x.contiguous(), w, stride, wgrad_int8,
                               per_sample, dgrad_int8)


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1
              ) -> torch.Tensor:
    """K2s, the serving conv (clip_resnet.py:62-92): x (N, H, W, I), w
    (O, I, k, k) f32 → (N, Ho, Wo, O) f32 with per-tensor activation and
    per-output-channel weight scales; no gradient."""
    k = w.shape[-1]
    with torch.no_grad():
        xq, xs = quantize(x.contiguous())
        wq, ks = quantize_weight(w)
        if x.is_cuda:
            from coin_tpu_torch.kernels.qconv import int8_conv_cuda
            return int8_conv_cuda(xq, wq, xs, ks, stride, k // 2)
        return qconv_plain(xq, wq, xs, ks, stride, k // 2)
