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
