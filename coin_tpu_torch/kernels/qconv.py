"""Launchers of K2, the int8 training convolution, and K2s, the int8 serving
convolution: ``csrc/quantize.cu`` (dynamic quantisation of activations and
gradients, one launch per tensor, writing K2 wgrad's layout beside the s8
values on request; the given-scale mode of a data-parallel step, an
abs-max launch and a quantise launch with an all-reduce between them;
both weight quantisations of a conv in one launch),
``csrc/qconv.cu`` (the s8 convolution with its f32 rescale, written in f32
or bf16: a ``wgmma`` implicit GEMM for the K2 forward, the K2 dgrad and
K2s, and a direct kernel for the stem's 3 channels) and
``csrc/qconv_wgrad.cu`` (the s8 weight gradient: a ``wgmma`` GEMM over the
laid-out operands).

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
_L = ctypes.c_longlong
_bound = {}
_scratch = {}
# u32 words of the quantiser's scratch: its barrier, then one partial per
# resident block (at most 8 blocks of 256 threads on each SM)
_SCRATCH_HEAD = 32


def _fn(lib: str, name: str, argtypes, restype=ctypes.c_int):
    """A library function, bound once."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(library(lib), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _bound[name] = fn
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{what}: every tensor must be on one CUDA device")


def _quant_scratch(dev: torch.device) -> torch.Tensor:
    """The quantiser's barrier and partials on ``dev`` for the current
    stream: zeroed once, left as the kernels find it by every launch.
    Launches that share one run in its stream's order; a launch from
    another stream (a side stream, a rank's) gets a scratch of its own."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    t = _scratch.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("quantize: launch once before capturing a "
                               "CUDA graph (its scratch is made then)")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        t = torch.zeros(_SCRATCH_HEAD + 8 * sms, dtype=torch.int32,
                        device=dev)
        _scratch[key] = t
    return t


def quantize_cuda(x: torch.Tensor, per_sample: bool, layout_k=None):
    """x (N, ...) f32 or bf16 on a CUDA device → (q int8 of x's shape,
    scale f32 of shape (N,) per sample or (1,) per tensor), in one launch.
    With ``layout_k`` (per tensor, x (N, H, W, C), C a multiple of 4) the
    same pass also writes K2 wgrad's layout of q for a k x k conv,
    ``ops/qconv.wgrad_layout_plain(q, k)``, and returns it third."""
    from coin_tpu_torch.ops.qconv import wgrad_positions
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
    lay = None
    dims = (0, 0, 0, 0, 0)
    if layout_k is not None:
        if per_sample or x.dim() != 4 or x.shape[-1] % 4:
            raise ValueError(f"quantize_cuda: a layout needs one scale and "
                             f"(N, H, W, C), C a multiple of 4; got "
                             f"{tuple(x.shape)}, per_sample={per_sample}")
        dims = (*x.shape, layout_k)
        lay = torch.empty((x.shape[-1], wgrad_positions(*x.shape[:3],
                                                        layout_k)),
                          dtype=torch.int8, device=x.device)
    scratch = _quant_scratch(x.device)
    err = _fn("quantize", "coin_quantize",
              [_P, _I, _L, _I, _P, _P, _P] + [_I] * 5 + [_P, _I, _P])(
        x.data_ptr(), _DTYPES[x.dtype], n, nseg, q.data_ptr(),
        scale.data_ptr(), None if lay is None else lay.data_ptr(), *dims,
        scratch.data_ptr(), scratch.numel(), _stream(x))
    check(err, "quantize")
    quantize_cuda.launches += 1
    return (q, scale) if lay is None else (q, scale, lay)


quantize_cuda.launches = 0


def _layout_out(x: torch.Tensor, layout_k, what: str):
    """K2 wgrad's (C, Pp) layout buffer for x (N, H, W, C), and the
    launch's shape arguments."""
    from coin_tpu_torch.ops.qconv import wgrad_positions
    if x.dim() != 4 or x.shape[-1] % 4:
        raise ValueError(f"{what}: a layout needs (N, H, W, C), C a "
                         f"multiple of 4; got {tuple(x.shape)}")
    lay = torch.empty((x.shape[-1], wgrad_positions(*x.shape[:3],
                                                    layout_k)),
                      dtype=torch.int8, device=x.device)
    return lay, (*x.shape, layout_k)


def absmax_cuda(x: torch.Tensor) -> torch.Tensor:
    """The given-scale mode's first launch: max |x| of an f32 or bf16
    tensor on a CUDA device as a (1,) f32 tensor (a NaN if x holds one),
    whose int32 view an all-reduce MAX combines across ranks."""
    _require_cuda("absmax_cuda", x)
    if x.dtype not in _DTYPES or x.numel() == 0:
        raise TypeError(f"absmax_cuda: {x.dtype} {tuple(x.shape)} (f32 or "
                        f"bf16, not empty)")
    x = x.contiguous()
    amax = torch.empty((1,), dtype=torch.float32, device=x.device)
    err = _fn("quantize", "coin_absmax", [_P, _I, _L, _P, _P])(
        x.data_ptr(), _DTYPES[x.dtype], x.numel(), amax.data_ptr(),
        _stream(x))
    check(err, "absmax")
    absmax_cuda.launches += 1
    return amax


absmax_cuda.launches = 0


def quantize_given_cuda(x: torch.Tensor, amax: torch.Tensor, layout_k=None):
    """The given-scale mode's second launch: x (f32 or bf16) on a CUDA
    device quantised with one scale, max(amax, 1e-12) / 127, from the
    (1,) f32 ``amax`` on the same device (the all-reduced abs-maxima of
    the ranks) → (q int8 of x's shape, scale (1,)), and with ``layout_k``
    K2 wgrad's layout of q third, as :func:`quantize_cuda` writes it."""
    _require_cuda("quantize_given_cuda", x, amax)
    if x.dtype not in _DTYPES or x.numel() == 0:
        raise TypeError(f"quantize_given_cuda: {x.dtype} "
                        f"{tuple(x.shape)} (f32 or bf16, not empty)")
    if amax.dtype != torch.float32 or amax.numel() != 1:
        raise TypeError(f"quantize_given_cuda: amax {amax.dtype} "
                        f"{tuple(amax.shape)} (one f32)")
    x, amax = x.contiguous(), amax.contiguous()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((1,), dtype=torch.float32, device=x.device)
    lay, dims = None, (0, 0, 0, 0, 0)
    if layout_k is not None:
        lay, dims = _layout_out(x, layout_k, "quantize_given_cuda")
    err = _fn("quantize", "coin_quantize_given",
              [_P, _I, _L, _P, _P, _P, _P] + [_I] * 5 + [_P])(
        x.data_ptr(), _DTYPES[x.dtype], x.numel(), amax.data_ptr(),
        q.data_ptr(), scale.data_ptr(),
        None if lay is None else lay.data_ptr(), *dims, _stream(x))
    check(err, "quantize_given")
    quantize_given_cuda.launches += 1
    return (q, scale) if lay is None else (q, scale, lay)


quantize_given_cuda.launches = 0


def _weight(what: str, w: torch.Tensor, max_k: int = 0) -> torch.Tensor:
    _require_cuda(what, w)
    if (w.dtype != torch.float32 or w.dim() != 4 or w.shape[2] != w.shape[3]
            or (max_k and w.shape[2] > max_k)):
        raise TypeError(f"{what}: {w.dtype} {tuple(w.shape)} (f32 (O, I, k, "
                        f"k){f', k <= {max_k}' if max_k else ''})")
    return w.contiguous()


def quantize_weight_cuda(w: torch.Tensor):
    """w (O, I, k, k) f32 on a CUDA device → (wq (O, k, k, I), scale (O,)),
    one scale per output channel (K2s and the int8-forward-only mode)."""
    w = _weight("quantize_weight_cuda", w)
    o, i, k, _ = w.shape
    wq = torch.empty((o, k, k, i), dtype=torch.int8, device=w.device)
    scale = torch.empty((o,), dtype=torch.float32, device=w.device)
    err = _fn("quantize", "coin_quantize_weight", [_P, _I, _I, _I, _P, _P,
                                                   _P])(
        w.data_ptr(), o, i, k, wq.data_ptr(), scale.data_ptr(), _stream(w))
    check(err, "quantize_weight")
    quantize_weight_cuda.launches += 1
    return wq, scale


quantize_weight_cuda.launches = 0


def quantize_weight_pair_cuda(w: torch.Tensor):
    """w (O, I, k, k) f32 on a CUDA device, k <= 3 → (wq (O, k, k, I),
    scale (O,), wt (I, k, k, O), scale_i (I,)) in one launch: the forward's
    weights per output channel and the dgrad's per input channel, of the
    spatially flipped kernel."""
    w = _weight("quantize_weight_pair_cuda", w, max_k=3)
    o, i, k, _ = w.shape
    wq = torch.empty((o, k, k, i), dtype=torch.int8, device=w.device)
    wt = torch.empty((i, k, k, o), dtype=torch.int8, device=w.device)
    words = _fn("quantize", "coin_quantize_weight_pair_words", [_I, _I],
                ctypes.c_longlong)(o, i)
    # the scales, then the kernel's partial maxima: one allocation
    buf = torch.empty((o + i + words,), dtype=torch.int32, device=w.device)
    scales, part = buf[:o + i].view(torch.float32), buf[o + i:]
    scratch = _quant_scratch(w.device)
    err = _fn("quantize", "coin_quantize_weight_pair",
              [_P, _I, _I, _I] + [_P] * 6 + [_I, _P])(
        w.data_ptr(), o, i, k, wq.data_ptr(), scales.data_ptr(),
        wt.data_ptr(), scales[o:].data_ptr(), part.data_ptr(),
        scratch.data_ptr(), scratch.numel(), _stream(w))
    check(err, "quantize_weight_pair")
    quantize_weight_pair_cuda.launches += 1
    return wq, scales[:o], wt, scales[o:]


quantize_weight_pair_cuda.launches = 0


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


def qconv_wgrad_cuda(xt: torch.Tensor, gt: torch.Tensor, xs: torch.Tensor,
                     gs: torch.Tensor, n: int, h: int, w: int,
                     k: int) -> torch.Tensor:
    """K2 wgrad of a stride-1 'same' conv over N images of H x W: xt (I,
    Pp) and gt (O, Pp) the s8 input and gradient in the layout that
    :func:`quantize_cuda` writes with ``layout_k=k``, xs and gs one f32 each
    → dw (O, I, k, k) f32 = f32(s32 sum, wrapping) * (xs * gs). The wgmma
    GEMM sums each tap as a shifted product; a last pass adds its splits
    and rescales."""
    from coin_tpu_torch.ops.qconv import wgrad_positions
    _require_cuda("qconv_wgrad_cuda", xt, gt, xs, gs)
    if xt.dtype != torch.int8 or gt.dtype != torch.int8:
        raise TypeError(f"qconv_wgrad_cuda: {xt.dtype}, {gt.dtype} (int8)")
    i, o = xt.shape[0], gt.shape[0]
    pp = wgrad_positions(n, h, w, k)
    if (xt.shape != (i, pp) or gt.shape != (o, pp) or xs.numel() != 1
            or gs.numel() != 1 or i % 4 or o % 4):
        raise ValueError(f"qconv_wgrad_cuda: layouts {tuple(xt.shape)}, "
                         f"{tuple(gt.shape)} for {(n, h, w)} (rows "
                         f"{pp}, channels multiples of 4), scales "
                         f"{xs.numel()}, {gs.numel()}")
    xt, gt = xt.contiguous(), gt.contiguous()
    xs, gs = xs.float().contiguous(), gs.float().contiguous()
    splits = _fn("qconv_wgrad", "coin_qconv_wgrad_splits", [_I] * 6)(
        n, h, w, i, o, k)
    part = torch.empty((splits, k * k, o, i), dtype=torch.int32,
                       device=xt.device)
    dw = torch.empty((o, i, k, k), dtype=torch.float32, device=xt.device)
    err = _fn("qconv_wgrad", "coin_qconv_wgrad", [_P] * 6 + [_I] * 7 + [_P])(
        xt.data_ptr(), gt.data_ptr(), xs.data_ptr(), gs.data_ptr(),
        part.data_ptr(), dw.data_ptr(), n, h, w, i, o, k, splits,
        _stream(xt))
    check(err, "qconv_wgrad")
    qconv_wgrad_cuda.launches += 1
    return dw


qconv_wgrad_cuda.launches = 0
