"""Dynamic-int8 convolutions (counterpart of coin_tpu/ops/qconv.py and of
``Int8Conv``'s arithmetic, coin_tpu/models/clip_resnet.py:62-92).

``int8_train_conv`` (K2) is the training conv of ``TPU.INT8_TRAIN``: the
forward quantises the activation (one scale per tensor, or per sample) and
the f32 master weight (one scale per output channel) to s8, accumulates in
s32 and rescales to f32; the backward quantises the incoming gradient the
same way against the weight quantised per input channel, flipped and
transposed (dgrad; the forward quantises both weights in one pass), and
takes the weight gradient either in s8 x s8 with per-tensor scales from the
saved s8 activation, kept in K2 wgrad's layout (mode ``qt=1``), or exactly
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


def quantize_weight_pair_plain(w: torch.Tensor):
    """Plain version of the one-pass weight quantisation of the int8 dgrad
    modes: (wq, scale) per output channel and (wt, scale_i) per input
    channel, flipped, as :func:`quantize_weight_plain` gives them."""
    return (*quantize_weight_plain(w), *quantize_weight_plain(w, True))


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
                col_scale: torch.Tensor, stride: int, pad: int,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the s8 convolution: xq (N, H, W, C), wq
    (O, k, k, C) → (N, Ho, Wo, O) = f32(s32 sum) * (row_scale *
    col_scale), row_scale (1,) or (N,), rounded to ``out_dtype``."""
    conv = lambda a, b: F.conv2d(a, b, stride=stride, padding=pad)
    acc = _exact_sum(conv, xq.permute(0, 3, 1, 2), wq.permute(0, 3, 1, 2),
                     wq[0].numel()).permute(0, 2, 3, 1)
    rs = row_scale.float().reshape(-1, 1, 1, 1)
    return _rescale(_wrap_s32(acc), rs, col_scale.float()).to(out_dtype)


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


def wgrad_image_block(k: int) -> int:
    """Images per block of K2 wgrad's layout: 128 for a k x k conv with
    k > 1, so that every tap shifts the positions by whole 128-byte TMA
    boxes; 1 for a 1 x 1 conv, whose layout is NHWC's own order."""
    return 128 if k > 1 else 1


def wgrad_positions(n: int, h: int, w: int, k: int) -> int:
    """Row length of K2 wgrad's layout: ceil(N / B) blocks of B images,
    each an (H + p) x (W + p) grid of pixels of B positions, p = k // 2,
    rounded up to 16 bytes."""
    p, b = k // 2, wgrad_image_block(k)
    return -(-(-(-n // b) * (h + p) * (w + p) * b) // 16) * 16


def wgrad_layout_plain(q: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of K2 wgrad's layout pass: q (N, H, W, C) → (C, Pp),
    channel-major over the positions (b, h, w, j) of image B b + j in
    blocks of B images (:func:`wgrad_image_block`), each block an (H + p) x
    (W + p) grid with p = k // 2 halo rows below and halo columns right of
    the image; zeros on the halo, for the images past N and past the grid.
    Tap (kh, kw) of the weight gradient is then the product of the
    gradient's layout with the input's shifted by a multiple of B positions
    (:func:`wgrad_tap_offset`)."""
    n, h, w, c = q.shape
    p, b = k // 2, wgrad_image_block(k)
    nb = -(-n // b)
    images = q.new_zeros((nb * b, h, w, c))
    images[:n] = q
    grid = q.new_zeros((nb, h + p, w + p, b, c))
    grid[:, :h, :w] = images.reshape(nb, b, h, w, c).permute(0, 2, 3, 1, 4)
    out = q.new_zeros((c, wgrad_positions(n, h, w, k)))
    out[:, :grid.numel() // c] = grid.reshape(-1, c).t()
    return out


def wgrad_tap_offset(w: int, k: int, tap: int) -> int:
    """The shift of tap ``tap`` = kh k + kw along the layout's positions:
    ((kh - p) (W + p) + kw - p) B. A pixel shifted by at most p rows and
    columns lands on its neighbour, on a halo column (of its row, or of the
    row above for a shift off the left edge), on a halo row (of its block,
    or of the block before for a shift off the top edge) or before the
    first position, where the shifted product reads zeros."""
    p = k // 2
    return ((tap // k - p) * (w + p) + (tap % k - p)) * wgrad_image_block(k)


def wgrad_unlayout_plain(t: torch.Tensor, n: int, h: int, w: int,
                         k: int) -> torch.Tensor:
    """The inverse of :func:`wgrad_layout_plain`: (C, Pp) → (N, H, W, C)."""
    c = t.shape[0]
    p, b = k // 2, wgrad_image_block(k)
    nb = -(-n // b)
    grid = t[:, :nb * (h + p) * (w + p) * b].reshape(c, nb, h + p, w + p, b)
    images = grid[:, :, :h, :w].permute(1, 4, 2, 3, 0)
    return images.reshape(nb * b, h, w, c)[:n].contiguous()


def qconv_wgrad_plain(xq: torch.Tensor, gq: torch.Tensor, xs: torch.Tensor,
                      gs: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of the s8 weight gradient of a stride-1 'same' conv:
    xq (N, H, W, I), gq (N, H, W, O) → dw (O, I, k, k) f32."""
    return _rescale(qconv_wgrad_s32_plain(xq, gq, k), xs.float().reshape(()),
                    gs.float().reshape(()))


# ----------------------------------------------------------- dispatch
def quantize(x: torch.Tensor, per_sample: bool = False, layout_k=None):
    """(q, scale) of x; with ``layout_k`` also K2 wgrad's layout of q for a
    k x k conv, written by the same kernel launch on a CUDA tensor."""
    if x.is_cuda:
        from coin_tpu_torch.kernels.qconv import quantize_cuda
        return quantize_cuda(x, per_sample, layout_k)
    q, s = quantize_plain(x, per_sample)
    if layout_k is None:
        return q, s
    return q, s, wgrad_layout_plain(q, layout_k)


def quantize_weight(w: torch.Tensor):
    """(wq, scale) per output channel."""
    if w.is_cuda:
        from coin_tpu_torch.kernels.qconv import quantize_weight_cuda
        return quantize_weight_cuda(w)
    return quantize_weight_plain(w)


def quantize_weight_pair(w: torch.Tensor):
    """(wq, scale) per output channel and (wt, scale_i) per input channel,
    flipped: one kernel launch on a CUDA tensor."""
    if w.is_cuda:
        from coin_tpu_torch.kernels.qconv import quantize_weight_pair_cuda
        return quantize_weight_pair_cuda(w)
    return quantize_weight_pair_plain(w)


def qconv_wgrad(xt: torch.Tensor, gt: torch.Tensor, xs: torch.Tensor,
                gs: torch.Tensor, n: int, h: int, w: int,
                k: int) -> torch.Tensor:
    """The s8 weight gradient from the laid-out operands: K2 wgrad on a
    CUDA tensor, the plain version of the NHWC tensors on a CPU one."""
    if xt.is_cuda:
        from coin_tpu_torch.kernels.qconv import qconv_wgrad_cuda
        return qconv_wgrad_cuda(xt, gt, xs, gs, n, h, w, k)
    return qconv_wgrad_plain(wgrad_unlayout_plain(xt, n, h, w, k),
                             wgrad_unlayout_plain(gt, n, h, w, k), xs, gs, k)


def _conv(which: str, xq: torch.Tensor, wq: torch.Tensor,
          row_scale: torch.Tensor, col_scale: torch.Tensor, stride: int,
          pad: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The s8 convolution, written in ``out_dtype`` (f32 or bf16), of one
    of the kernel's three users (``fwd``, ``dgrad``, ``serve``, counted
    apart) on a CUDA tensor; its plain version on a CPU one."""
    if not xq.is_cuda:
        return qconv_plain(xq, wq, row_scale, col_scale, stride, pad,
                           out_dtype)
    from coin_tpu_torch.kernels import qconv as kq
    if which == "fwd":
        return kq.qconv_fwd_cuda(xq, wq, row_scale, col_scale, stride, pad,
                                 out_dtype)
    if which == "dgrad":
        return kq.qconv_dgrad_cuda(xq, wq, row_scale, col_scale, pad,
                                   out_dtype)
    return kq.int8_conv_cuda(xq, wq, row_scale, col_scale, stride, pad,
                             out_dtype)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


class Int8TrainConv(torch.autograd.Function):
    """The custom VJP of coin_tpu/ops/qconv.py:135-215, with the output's
    dtype chosen by the caller (JAX returns f32 and its modules cast right
    after: ``Int8TrainConv.__call__``'s ``out.astype(self.dtype)``, the
    same round to nearest even of the same f32 that the kernel's epilogue
    writes). With a bf16 output the cotangent reaches ``backward`` as bf16
    and is quantised as it arrives: JAX widens the same bf16 values to f32
    first (:181), which is exact, so the s8 values and scales are the same;
    the exact paths' ``g.to(x_dtype)`` see the same values too.

    The forward quantises both weights at once where the dgrad is int8
    (the backward keeps them: the master weight does not change in
    between) and, in mode 1, writes K2 wgrad's layout of the s8 activation
    beside its NHWC values; it saves the layout, not the NHWC tensor. The
    backward's quantisation of the gradient does the same for the
    gradient."""

    @staticmethod
    def forward(ctx, x, w, stride, wgrad_int8, per_sample, dgrad_int8,
                out_dtype):
        int8_res = wgrad_int8 and dgrad_int8 and stride == 1 \
            and not per_sample
        dgrad_i8 = dgrad_int8 and stride == 1
        k = w.shape[-1]
        if int8_res:
            xq, xs, xt = quantize(x, layout_k=k)
        else:
            xq, xs = quantize(x, per_sample)
        if dgrad_i8:
            wq, ks, wt, ks_i = quantize_weight_pair(w)
        else:
            wq, ks = quantize_weight(w)
        out = _conv("fwd", xq, wq, xs, ks, stride, k // 2, out_dtype)
        ctx.meta = (stride, per_sample, dgrad_i8, int8_res, x.dtype,
                    tuple(x.shape), tuple(w.shape), w.dtype)
        # mode 1 keeps the s8 activation, laid out for the wgrad, and its
        # scale, not x: half the bytes of a bf16 activation, and no
        # requantisation in the backward
        if int8_res:
            ctx.save_for_backward(xt, xs, wt, ks_i)
        elif dgrad_i8:
            ctx.save_for_backward(x, wt, ks_i)
        else:
            ctx.save_for_backward(x, w)
        return out

    @staticmethod
    def backward(ctx, g):
        stride, per_sample, dgrad_i8, int8_res, x_dtype, x_shape, w_shape, \
            w_dtype = ctx.meta
        if int8_res:
            xt, xs, wt, ks_i = ctx.saved_tensors
        elif dgrad_i8:
            x, wt, ks_i = ctx.saved_tensors
        else:
            x, w = ctx.saved_tensors
        n, h, wd, _ = x_shape
        k = w_shape[-1]
        p = k // 2
        g = g.contiguous()
        if dgrad_i8:
            if int8_res:
                gq, gs, gt = quantize(g, layout_k=k)
            else:
                gq, gs = quantize(g, per_sample)
            dx = _conv("dgrad", gq, wt, gs, ks_i, 1, p, x_dtype)
        else:
            dx = _nhwc(torch.nn.grad.conv2d_input(
                (n, x_shape[3], h, wd), w.to(x_dtype), _nchw(g.to(x_dtype)),
                stride=stride, padding=p))
        if int8_res:
            dw = qconv_wgrad(xt, gt, xs, gs, n, h, wd, k)
        else:
            dw = torch.nn.grad.conv2d_weight(
                _nchw(x), w_shape, _nchw(g.to(x.dtype)), stride=stride,
                padding=p)
        return dx, dw.to(w_dtype), None, None, None, None, None


def int8_train_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                    wgrad_int8: bool = False, per_sample: bool = False,
                    dgrad_int8: bool = True,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (N, H, W, I) in the compute dtype, w (O, I, k, k) the f32 master
    weight → (N, Ho, Wo, O); padding k // 2. The output is f32 as JAX's
    function returns it, or its rounding to ``out_dtype``, written by the
    kernel. Gradients: dx in x's dtype, dw in w's. Where no gradient is
    taken (inference, a teacher's forward) only the forward's operands are
    quantised."""
    if not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        k = w.shape[-1]
        xq, xs = quantize(x.contiguous(), per_sample)
        wq, ks = quantize_weight(w)
        return _conv("fwd", xq, wq, xs, ks, stride, k // 2, out_dtype)
    return Int8TrainConv.apply(x.contiguous(), w, stride, wgrad_int8,
                               per_sample, dgrad_int8, out_dtype)


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K2s, the serving conv (clip_resnet.py:62-92): x (N, H, W, I), w
    (O, I, k, k) f32 → (N, Ho, Wo, O) with per-tensor activation and
    per-output-channel weight scales, f32 or rounded to ``out_dtype`` (the
    module's ``.astype(dtype)``); no gradient."""
    k = w.shape[-1]
    with torch.no_grad():
        xq, xs = quantize(x.contiguous())
        wq, ks = quantize_weight(w)
        return _conv("serve", xq, wq, xs, ks, stride, k // 2, out_dtype)
