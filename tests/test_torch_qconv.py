"""The int8 convolutions of coin_tpu_torch (ops/qconv.py: K2
``int8_train_conv`` and K2s ``int8_conv``) against the JAX package's
``coin_tpu.ops.qconv.int8_train_conv`` (gradients through ``jax.vjp``) and
``coin_tpu.models.clip_resnet.Int8Conv`` on the CPU, where the port runs the
kernels' plain versions.

The JAX functions run op by op (``jax.disable_jit``), each primitive one
IEEE operation in the source's order, which is what the port computes.
(Under ``jit`` XLA rewrites ``amax / 127.0`` into a product with the
reciprocal and folds 1/127**2 into the rescale: the compiled JAX function
differs from its own source by an ulp here and there in the scales; the
slice-level tests in test_torch_trainer.py meet it with a stated
tolerance.)

Inputs are drawn with numpy from a seed and fed to both sides. Where JAX
computes in integers (the forward, the int8 dgrad of modes 1-3, the int8
wgrad of mode 1) the port must agree bit for bit: the same s8 values, the
same s32 sums, the same f32 rescale. The exact paths (mode 4's dgrad, the
wgrad of modes 2-4) are plain convolutions in the activation's dtype, summed
in another order: within 1e-5 of the largest entry in f32, and within
2**-7 (two bf16 ulps) of it in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from coin_tpu.models.clip_resnet import Int8Conv as JInt8Conv
from coin_tpu.ops.qconv import int8_train_conv as jconv
from coin_tpu_torch.ops import qconv as tq
from tests.test_torch_models import two_torch_threads  # noqa: F401

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
EXACT_TOL = {"f32": 1e-5, "bf16": 2.0 ** -7}


def _flags(qt):
    """(wgrad_int8, per_sample, dgrad_int8) of ``_conv``'s mode qt."""
    return qt == 1, qt in (3, 4), qt != 4


def _inputs(seed, k, n=3, hw=6, cin=16, cout=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, hw, hw, cin).astype(np.float32)
    x[1] *= 0.05                          # one quiet sample: scales differ
    w = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
    g = rng.randn(n, hw, hw, cout).astype(np.float32)
    g[2] *= 1e-3
    return x, w, g


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _as_f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("qt", [1, 2, 3, 4])
def test_int8_train_conv_matches_jax(qt, k, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, g = _inputs(10 * qt + k, k)
    flags = _flags(qt)
    jx = jnp.asarray(x, jdt)

    with jax.disable_jit():
        jy, vjp = jax.vjp(lambda a, b: jconv(a, b, 1, *flags), jx,
                          jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tw = _oihw(w).requires_grad_(True)
    ty = tq.int8_train_conv(tx, tw, 1, *flags)
    assert ty.dtype == torch.float32 and ty.shape == jy.shape
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    ty.backward(torch.from_numpy(g))
    assert tx.grad.dtype == tdt and tw.grad.dtype == torch.float32

    dx, want_dx = _as_f32(tx.grad), _as_f32(jdx)
    if flags[2]:                       # int8 dgrad: s32 sums, exact rescale
        np.testing.assert_array_equal(dx, want_dx)
    else:
        tol = EXACT_TOL[dtype] * np.abs(want_dx).max()
        np.testing.assert_allclose(dx, want_dx, rtol=0, atol=tol)
    dw = tw.grad.numpy().transpose(2, 3, 1, 0)          # back to HWIO
    want_dw = np.asarray(jdw)
    if flags[0]:                       # int8 wgrad from the s8 residuals
        np.testing.assert_array_equal(dw, want_dw)
    else:
        tol = EXACT_TOL[dtype] * np.abs(want_dw).max()
        np.testing.assert_allclose(dw, want_dw, rtol=0, atol=tol)


def test_int8_conv_stride2_stem_matches_jax():
    """K2s at the stem's geometry: 3 input channels, 3x3, stride 2, on a
    bf16 image; bit for bit."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 17, 22, 3).astype(np.float32)
    w = (rng.randn(3, 3, 3, 16) / np.sqrt(27)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    with jax.disable_jit():
        want = JInt8Conv(16, 3, 2, dtype=jnp.float32).apply(
            {"params": {"kernel": jnp.asarray(w)}}, jx)
    got = tq.int8_conv(torch.from_numpy(x).to(torch.bfloat16), _oihw(w), 2)
    assert got.shape == want.shape == (2, 9, 11, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("qt", [0, 1, 3])
def test_bf16_output_matches_jax_modules(qt):
    """The convolution written in bf16 (the kernels' epilogue; on the CPU
    ``qconv_plain(..., out_dtype)``) against JAX's modules with
    ``dtype=bfloat16``, which round the f32 result: ``Int8Conv`` (qt 0,
    ``int8_conv``, 3x3 at stride 1 and 2) and ``Int8TrainConv`` (qt 1 and
    3, ``int8_train_conv``), bit for bit; for qt 1 the gradients from a
    bf16 cotangent too (the int8 dgrad and wgrad: bit for bit)."""
    from coin_tpu.models.clip_resnet import Int8TrainConv as JInt8Train
    x, w, g = _inputs(50 + qt, 3)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    params = {"params": {"kernel": jnp.asarray(w)}}
    if qt == 0:
        for stride in (1, 2):
            with jax.disable_jit():
                want = JInt8Conv(8, 3, stride, dtype=jnp.bfloat16).apply(
                    params, jx)
            got = tq.int8_conv(tx, _oihw(w), stride,
                               out_dtype=torch.bfloat16)
            assert got.dtype == torch.bfloat16 and got.shape == want.shape
            np.testing.assert_array_equal(_as_f32(got), _as_f32(want))
        return
    flags = _flags(qt)
    module = JInt8Train(8, 3, 1, dtype=jnp.bfloat16, wgrad_int8=flags[0],
                        per_sample=flags[1], dgrad_int8=flags[2])
    jg = jnp.asarray(g, jnp.bfloat16)
    with jax.disable_jit():
        jy, vjp = jax.vjp(lambda a, b: module.apply(
            {"params": {"kernel": b}}, a), jx, jnp.asarray(w))
        jdx, jdw = vjp(jg)
    tx.requires_grad_(True)
    tw = _oihw(w).requires_grad_(True)
    ty = tq.int8_train_conv(tx, tw, 1, *flags, out_dtype=torch.bfloat16)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(_as_f32(ty.detach()), _as_f32(jy))
    if qt == 1:
        ty.backward(torch.from_numpy(g).to(torch.bfloat16))
        np.testing.assert_array_equal(_as_f32(tx.grad), _as_f32(jdx))
        np.testing.assert_array_equal(tw.grad.numpy().transpose(2, 3, 1, 0),
                                      np.asarray(jdw))


@pytest.mark.parametrize("qt", [1, 2, 3, 4])
def test_bf16_output_gradients_equal_f32_outputs(qt):
    """``out_dtype=bf16`` changes where the f32 result is rounded, not what
    flows back: the output equals the f32 output cast to bf16, and the
    gradients from one bf16 cotangent (which reaches the backward as bf16
    instead of widened to f32) are the same bits in every mode."""
    x, w, g = _inputs(60 + qt, 3)
    flags = _flags(qt)
    res = []
    for out_dtype in (torch.bfloat16, torch.float32):
        tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
        tw = _oihw(w).requires_grad_(True)
        ty = tq.int8_train_conv(tx, tw, 1, *flags, out_dtype=out_dtype)
        ty = ty.to(torch.bfloat16)
        ty.backward(torch.from_numpy(g).to(torch.bfloat16))
        res.append((ty.detach(), tx.grad, tw.grad))
    for name, a, b in zip(("y", "dx", "dw"), *res):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_quantizers_match_jax_bit_for_bit():
    """The s8 values and scales of both quantisations, per tensor and per
    sample, and of the weight per output and per input channel (flipped
    and transposed for the dgrad)."""
    from coin_tpu.ops.qconv import _quantize_x
    x, w, _ = _inputs(3, 3)
    for per_sample in (False, True):
        with jax.disable_jit():
            jq, js = _quantize_x(jnp.asarray(x), per_sample)
        tqv, ts = tq.quantize_plain(torch.from_numpy(x), per_sample)
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(),
                                      np.asarray(js).reshape(-1))

    def weights(wf):          # qconv.py:92-93 and :190-193
        ks = jnp.maximum(jnp.max(jnp.abs(wf), axis=(0, 1, 2)), 1e-12) / 127.0
        ks_i = jnp.maximum(jnp.max(jnp.abs(wf), axis=(0, 1, 3)),
                           1e-12) / 127.0
        return (jnp.round(wf / ks).astype(jnp.int8), ks,
                jnp.round(wf / ks_i[None, None, :, None]).astype(jnp.int8),
                ks_i)
    with jax.disable_jit():
        wq, ks, wq_i, ks_i = map(np.asarray, weights(jnp.asarray(w)))
    got, s = tq.quantize_weight_plain(_oihw(w))
    np.testing.assert_array_equal(got.numpy(), wq.transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(s.numpy(), ks)
    wt = wq_i[::-1, ::-1].transpose(0, 1, 3, 2)                # (k,k,O,I)
    got, s = tq.quantize_weight_plain(_oihw(w), per_input=True)
    np.testing.assert_array_equal(got.numpy(), wt.transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(s.numpy(), ks_i)


def test_quantizers_propagate_nan_like_jax():
    """A NaN makes its segment's scale NaN and every s8 value quantised
    with that scale 0 (XLA's NaN convert); the other segments and the other
    weight channels are untouched. The CUDA kernel is held to this plain
    version in test_torch_kernels_cuda.py."""
    from coin_tpu.ops.qconv import _quantize_x
    x, w, _ = _inputs(4, 3)
    x[1, 2, 3, 5] = np.nan
    for per_sample in (False, True):
        with jax.disable_jit():
            jq, js = _quantize_x(jnp.asarray(x), per_sample)
        tqv, ts = tq.quantize_plain(torch.from_numpy(x), per_sample)
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js).reshape(-1))
        assert np.isnan(ts.numpy()).sum() == 1 and not tqv[1].any()
        assert tqv[0].any() == per_sample
    w[0, 1, 2, 3] = np.nan                                    # output 3
    with jax.disable_jit():
        wf = jnp.asarray(w)
        ks = jnp.maximum(jnp.max(jnp.abs(wf), axis=(0, 1, 2)), 1e-12) / 127.0
        wq = np.asarray(jnp.round(wf / ks).astype(jnp.int8))
    got, s = tq.quantize_weight_plain(_oihw(w))
    np.testing.assert_array_equal(got.numpy(), wq.transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ks))
    assert np.isnan(s.numpy()).sum() == 1 and not got[3].any()


def test_plain_wgrad_wraps_like_xla_s32():
    """A weight-gradient sum past 2**31 wraps to the s32 XLA's conv holds:
    143 360 positions of 127 x 127 sum to 2 312 253 440."""
    n, hw = 35, 64
    xq = np.full((n, hw, hw, 4), 127, np.int8)
    gq = np.full((n, hw, hw, 4), 127, np.int8)
    gq[..., 1] = -127
    want = lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(gq), (1, 1), [(0, 0)] * 2,
        dimension_numbers=("CHWN", "IHWO", "HWNC"),
        preferred_element_type=jnp.int32)                      # (1,1,I,O)
    total = n * hw * hw * 127 * 127
    assert total > 2 ** 31
    wrapped = (total + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert int(np.asarray(want)[0, 0, 0, 0]) == wrapped
    one = torch.ones(1)
    got = tq.qconv_wgrad_plain(torch.from_numpy(xq), torch.from_numpy(gq),
                               one, one, 1)                    # (O,I,1,1)
    np.testing.assert_array_equal(
        got[:, :, 0, 0].numpy(),
        np.asarray(want)[0, 0].T.astype(np.float32))
    assert float(got[0, 0, 0, 0]) == float(np.float32(wrapped)) < 0


@pytest.mark.parametrize("which", ["conv", "wgrad"])
def test_plain_integer_sums_are_exact(which):
    """The plain versions' integer sums at res5's longest contractions
    (3x3 over 512 channels; a weight gradient over 88 crops of 14 x 14,
    summed in chunks) equal int64 sums: their f32 partial convolutions
    never round."""
    rng = np.random.RandomState(7)
    # mostly positive values, so that the sums grow past 2**24
    xq = rng.randint(-10, 128, (88, 14, 14, 512 if which == "conv" else 8))
    if which == "conv":
        xq = xq[:2, :5, :5]
        wq = rng.randint(60, 128, (4, 3, 3, 512))
        one = torch.ones(1)
        got = tq.qconv_plain(torch.from_numpy(xq).to(torch.int8),
                             torch.from_numpy(wq).to(torch.int8), one,
                             torch.ones(4), 1, 1)
        pad = np.pad(xq, ((0, 0), (1, 1), (1, 1), (0, 0))).astype(np.int64)
        want = sum(np.einsum("nhwc,oc->nhwo", pad[:, a:a + 5, b:b + 5],
                             wq[:, a, b].astype(np.int64))
                   for a in range(3) for b in range(3))
    else:
        gq = rng.randint(-10, 128, (88, 14, 14, 4))
        one = torch.ones(1)
        got = tq.qconv_wgrad_plain(torch.from_numpy(xq).to(torch.int8),
                                   torch.from_numpy(gq).to(torch.int8), one,
                                   one, 1)[:, :, 0, 0]
        want = np.einsum("nhwi,nhwo->oi", xq.astype(np.int64),
                         gq.astype(np.int64))
    assert np.abs(want).max() > 2 ** 24          # past f32's exact range
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def _shifted_gemm(xq, gq, k):
    """K2 wgrad's algorithm in int64: both operands through the plain
    layout pass, each tap the gradient's layout times the input's shifted
    along the positions (zeros off either end, as TMA reads them), wrapped
    to s32."""
    w = xq.shape[2]
    xt = tq.wgrad_layout_plain(torch.from_numpy(xq), k).numpy()
    gt = tq.wgrad_layout_plain(torch.from_numpy(gq), k).numpy()
    xt, gt = xt.astype(np.int64), gt.astype(np.int64)
    pp = xt.shape[1]
    out = np.zeros((gq.shape[-1], xq.shape[-1], k, k), np.int64)
    for tap in range(k * k):
        off = tq.wgrad_tap_offset(w, k, tap)
        shifted = np.zeros_like(xt)
        if off >= 0:
            shifted[:, :pp - off] = xt[:, off:]
        else:
            shifted[:, -off:] = xt[:, :pp + off]
        out[:, :, tap // k, tap % k] = gt @ shifted.T
    return ((out + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)


@pytest.mark.parametrize("n,hw,cin,cout,k,wrap", [
    (3, 7, 8, 12, 1, False), (5, 7, 8, 4, 3, False),
    (3, 14, 4, 8, 3, False), (5, 14, 12, 8, 1, False),
    (2719, 7, 4, 4, 3, True)])
def test_wgrad_layout_shifted_gemm_matches_jax(n, hw, cin, cout, k, wrap):
    """K2 wgrad's design on the CPU: the layout pass's plain version (the
    channel-major grid of pixels, blocks of images innermost, with k // 2
    halo rows and columns) feeding a GEMM per tap shifted by
    ``wgrad_tap_offset`` (whole 128-byte TMA boxes) gives the s32
    sums of ``qconv_wgrad_s32_plain`` and of JAX's wgrad
    (coin_tpu/ops/qconv.py:203) bit for bit, and so the same f32 gradient.
    The last case's centre tap passes 2**31 (2719 x 49 products of 127 x
    127) and wraps."""
    rng = np.random.RandomState(n + k)
    if wrap:
        xq = np.full((n, hw, hw, cin), 127, np.int8)
        gq = np.full((n, hw, hw, cout), 127, np.int8)
        gq[..., 1] = -127
    else:
        xq = rng.randint(-127, 128, (n, hw, hw, cin)).astype(np.int8)
        gq = rng.randint(-127, 128, (n, hw, hw, cout)).astype(np.int8)
    layout = tq.wgrad_layout_plain(torch.from_numpy(xq), k).numpy()
    p, b = k // 2, tq.wgrad_image_block(k)
    nb = -(-n // b)
    size = nb * (hw + p) ** 2 * b
    assert layout.shape == (cin, tq.wgrad_positions(n, hw, hw, k))
    assert layout.shape[1] % 16 == 0 and not layout[:, size:].any()
    grid = layout[:, :size].reshape(cin, nb, hw + p, hw + p, b)
    images = np.zeros((nb * b, hw, hw, cin), np.int8)
    images[:n] = xq
    np.testing.assert_array_equal(
        grid[:, :, :hw, :hw],
        images.reshape(nb, b, hw, hw, cin).transpose(4, 0, 2, 3, 1))
    assert not grid[:, :, hw:].any() and not grid[:, :, :, hw:].any()
    got = _shifted_gemm(xq, gq, k)
    plain = tq.qconv_wgrad_s32_plain(torch.from_numpy(xq),
                                     torch.from_numpy(gq), k).numpy()
    jax_s32 = np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(gq), (1, 1), [(p, p)] * 2,
        dimension_numbers=("CHWN", "IHWO", "HWNC"),
        preferred_element_type=jnp.int32)).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_s32)
    if wrap:
        assert got[0, 0, p, p] < 0 < got[0, 0, 0, 0]
    xs, gs = np.float32(0.03), np.float32(1.7e-4)
    want = np.asarray(jnp.asarray(jax_s32, jnp.float32)
                      * (jnp.float32(xs) * jnp.float32(gs)))
    dw = tq._rescale(torch.from_numpy(got), torch.tensor(xs),
                     torch.tensor(gs))
    np.testing.assert_array_equal(dw.numpy(), want)


@pytest.mark.parametrize("n,hw,c,k,nan", [
    (3, 5, 8, 1, False), (130, 3, 12, 3, False), (5, 7, 16, 3, True),
    (131, 2, 4, 1, True)])
def test_quantize_writes_the_wgrad_layout_of_jax_s8(n, hw, c, k, nan):
    """The layout that the quantisation writes beside the s8 values (mode
    1's activation and gradient) is ``wgrad_layout_plain`` of JAX's
    ``_quantize_x`` output (coin_tpu/ops/qconv.py:63), byte for byte: per
    tensor, 1 x 1 and 3 x 3, N off the 128-image blocks, with a NaN (whose
    NaN scale makes every value 0). The layout reads back to the same s8
    tensor. The CUDA kernel is held to these plain versions in
    test_torch_kernels_cuda.py."""
    from coin_tpu.ops.qconv import _quantize_x
    rng = np.random.RandomState(n + k)
    x = rng.randn(n, hw, hw, c).astype(np.float32)
    if nan:
        x[n // 2, 0, hw - 1, c - 1] = np.nan
    with jax.disable_jit():
        jq, js = (np.array(a) for a in _quantize_x(jnp.asarray(x)))
    q, s, lay = tq.quantize(torch.from_numpy(x), layout_k=k)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js.reshape(-1))
    want = tq.wgrad_layout_plain(torch.from_numpy(jq), k)
    assert lay.dtype == torch.int8 and torch.equal(lay, want)
    assert lay.shape == (c, tq.wgrad_positions(n, hw, hw, k))
    assert torch.equal(tq.wgrad_unlayout_plain(lay, n, hw, hw, k),
                       torch.from_numpy(jq))
    assert bool(np.isnan(js).all()) == nan and (nan or lay.any())


@pytest.mark.parametrize("k", [1, 3])
def test_weight_pair_matches_jax_forward_and_dgrad_weights(k):
    """Both weight quantisations of one pass (the forward's per output
    channel, qconv.py:92-93; the dgrad's per input channel, flipped and
    transposed, :190-193) against JAX op by op, bit for bit, a NaN
    included (its output and input channel get NaN scales and zeros)."""
    rng = np.random.RandomState(20 + k)
    w = (rng.randn(k, k, 24, 40) / np.sqrt(k * k * 24)).astype(np.float32)
    w[0, k - 1, 5, 7] = np.nan
    with jax.disable_jit():
        wf = jnp.asarray(w)
        ks = jnp.maximum(jnp.max(jnp.abs(wf), axis=(0, 1, 2)), 1e-12) / 127.0
        ks_i = jnp.maximum(jnp.max(jnp.abs(wf), axis=(0, 1, 3)),
                           1e-12) / 127.0
        wq = np.asarray(jnp.round(wf / ks).astype(jnp.int8))
        wq_i = np.asarray(jnp.round(wf / ks_i[None, None, :, None])
                          .astype(jnp.int8))
    got = tq.quantize_weight_pair(_oihw(w))
    same = lambda a, b: np.testing.assert_array_equal(a.numpy(), b)
    same(got[0], wq.transpose(3, 0, 1, 2))
    same(got[1], np.asarray(ks))
    same(got[2], wq_i[::-1, ::-1].transpose(2, 0, 1, 3))
    same(got[3], np.asarray(ks_i))
    assert np.isnan(got[1].numpy()).sum() == np.isnan(got[3].numpy()).sum() \
        == 1


@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_bf16_cotangent_is_quantised_as_it_arrives(out):
    """Mode 1 with a bf16 cotangent, read by the backward as it arrives,
    gives the dx and dw of the same cotangent widened to f32 (widening is
    exact, so the s8 gradient and its scale are the same), and those of
    JAX's module (coin_tpu/models/clip_resnet.py ``Int8TrainConv``, whose
    backward widens the bf16 cotangent at qconv.py:181) bit for bit, as
    mode 1's int8 dgrad and wgrad are."""
    from coin_tpu.models.clip_resnet import Int8TrainConv as JInt8Train
    x, w, g = _inputs(70, 3)
    tdt = DTYPES[out][1]
    gb = torch.from_numpy(g).to(torch.bfloat16)
    grads = []
    for cot in (gb, gb.float()):
        tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
        tw = _oihw(w).requires_grad_(True)
        ty = tq.int8_train_conv(tx, tw, 1, *_flags(1), out_dtype=tdt)
        ty.backward(cot.to(tdt) if cot.dtype != tdt else cot)
        grads.append((tx.grad, tw.grad))
    assert grads[0][0].dtype == torch.bfloat16
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    module = JInt8Train(8, 3, 1, dtype=jnp.bfloat16, wgrad_int8=True,
                        per_sample=False, dgrad_int8=True)
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda a, b: module.apply(
            {"params": {"kernel": b}}, a), jnp.asarray(x, jnp.bfloat16),
            jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(g, jnp.bfloat16))
    np.testing.assert_array_equal(_as_f32(grads[0][0]), _as_f32(jdx))
    np.testing.assert_array_equal(
        grads[0][1].numpy().transpose(2, 3, 1, 0), np.asarray(jdw))
