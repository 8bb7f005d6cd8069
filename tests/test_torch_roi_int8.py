"""The int8 RoIAlign of coin_tpu_torch (ops/roi_align.py: K5's plain
forward and K5b's plain backward, ``OpenVocabularyRCNN(quant_roi=True)``)
against the JAX package's ``coin_tpu.ops.roi_align.roi_align_int8`` on the
CPU, where the port runs the kernels' plain versions.

The forward is held bit for bit to JAX run op by op (``jax.disable_jit``):
every sum is an exact integer and each rounding is one IEEE operation in
the source's order. (Compiled JAX multiplies by 1/127 where the source
divides; see tests/test_torch_qconv.py.) Both contraction orders (w >= h
and h > w), f32 and bf16 features, and a map whose s8 intermediate
saturates at the clip (ADVICE.md: a row of the s8 interpolation matrix can
sum past 127).

The backward is ``_ra_int8_bwd``'s transpose, through ``jax.vjp`` (its
bf16 einsums on f32 copies of their operands: XLA's CPU runtime lacks that
bf16 x bf16 -> f32 dot, and exact products summed in f32 are its
definition): the
intermediate t = Σ_r ay·g rounded to the features' dtype, then f32 sums in
another order than XLA's. Measured on these inputs: at most 3.1e-7 of the
largest entry in f32, 0 in bf16. Held to 2e-6 in f32 and, in bf16, where
a sum near a rounding boundary of t may round to the neighbouring value,
to 2**-7 (two bf16 ulps) of the largest entry, as the exact int8 conv
paths are held. The RoIs get a zero gradient on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coin_tpu.ops import roi_align as jroi
from coin_tpu_torch.ops import roi_align as troi
from tests.test_torch_models import _apply, random_rois, tiny_pair
from tests.test_torch_models import two_torch_threads  # noqa: F401

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BWD_TOL = {"f32": 2e-6, "bf16": 2.0 ** -7}
SCALE = 1.0 / 16.0


def _rois(rng, n, h, w):
    xy = rng.uniform(-20, 16.0 * max(h, w), (n, 2))
    wh = rng.uniform(1, 16.0 * max(h, w) / 2, (n, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[0] = [-40.0, -30.0, 60.0, 50.0]                  # partly outside
    rois[1] = [16.0 * w - 30, 16.0 * h - 20, 16.0 * w + 90,
               16.0 * h + 70]                             # past far edge
    rois[2] = [33.0, 41.0, 33.5, 41.2]                    # tiny
    rois[3] = [50.0, 50.0, 50.0, 50.0]                    # empty
    rois[4] = [0.0, 0.0, 16.0 * w, 16.0 * h]              # whole map
    return rois


def _feats(rng, b, h, w, c):
    f = rng.randn(b, h, w, c).astype(np.float32)
    f *= rng.uniform(0.01, 3.0, (1, 1, 1, c)).astype(np.float32)
    return f


def _jax_int8(feats, rois, jdt):
    with jax.disable_jit():
        return np.stack([np.asarray(jroi.roi_align_int8(
            jnp.asarray(f, jdt), jnp.asarray(r), SCALE, 14, 2)).astype(
                np.float32) for f, r in zip(feats, rois)])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hw", [(9, 15), (15, 9)], ids=["w>=h", "h>w"])
def test_roi_align_int8_plain_matches_jax_bit_for_bit(rng, hw, dtype):
    jdt, tdt = DTYPES[dtype]
    h, w = hw
    feats = _feats(rng, 2, h, w, 8)
    feats = np.asarray(jnp.asarray(feats, jdt).astype(jnp.float32))
    rois = np.stack([_rois(rng, 12, h, w) for _ in range(2)])
    want = _jax_int8(feats, rois, jdt)
    got = troi.roi_align_int8_batched(
        torch.from_numpy(feats).to(tdt), torch.from_numpy(rois), SCALE, 14,
        2)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("hw", [(6, 10), (10, 6)], ids=["w>=h", "h>w"])
def test_roi_align_int8_saturating_intermediate_matches_jax(hw):
    """Every feature of channel 0 at its abs-max (s8 127): the first
    contraction gives 127 times the s8 row sum, so wherever a row of the
    first s8 interpolation matrix sums past 127 the requantised
    intermediate exceeds 127 and the clip saturates it. No NaN anywhere."""
    h, w = hw
    feats = np.ones((1, h, w, 4), np.float32)
    feats[..., 1] = -2.5
    feats[..., 2:] = np.random.RandomState(3).randn(h, w, 2)
    # sample positions that put the two samples of each cell on
    # neighbouring taps: many s8 rows sum to 128 or 129
    rois = np.array([[[3.3, 5.1, 3.3 + 16 * (w - 1) * 0.93,
                       5.1 + 16 * (h - 1) * 0.97],
                      [17.0, 9.0, 17.0 + 16 * 2.7, 9.0 + 16 * 2.3],
                      [1.0, 1.0, 16 * w - 1.0, 16 * h - 1.0]]], np.float32)
    ax, ay = troi._interp_pair(torch.from_numpy(rois[0]), SCALE, 14, 2, h,
                               w)
    first = ax if w >= h else ay
    rowsum = (first * 127.0).round().sum(-1)
    assert rowsum.max() > 127, rowsum.max()
    want = _jax_int8(feats, rois, jnp.float32)
    got = troi.roi_align_int8_batched(torch.from_numpy(feats),
                                      torch.from_numpy(rois), SCALE, 14, 2)
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hw", [(7, 12), (12, 7)], ids=["w>=h", "h>w"])
def test_roi_align_int8_backward_matches_jax(rng, monkeypatch, hw, dtype):
    jdt, tdt = DTYPES[dtype]
    einsum = jnp.einsum

    def exact_product_einsum(*args, preferred_element_type=None, **kw):
        """XLA's CPU runtime has no bf16 x bf16 -> f32 dot for the
        backward's second einsum; the same dot on f32 copies of the bf16
        operands is that dot's definition (exact products, f32 sums)."""
        if preferred_element_type == jnp.float32:
            args = [a.astype(jnp.float32) if getattr(a, "dtype", None)
                    == jnp.bfloat16 else a for a in args]
        return einsum(*args, preferred_element_type=preferred_element_type,
                      **kw)

    monkeypatch.setattr(jnp, "einsum", exact_product_einsum)
    h, w = hw
    feats = _feats(rng, 1, h, w, 8)[0]
    rois = _rois(rng, 10, h, w)
    g = rng.randn(10, 14, 14, 8).astype(np.float32)
    g = np.asarray(jnp.asarray(g, jdt).astype(jnp.float32))
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda f, r: jroi.roi_align_int8(f, r, SCALE, 14,
                                                         2),
                         jnp.asarray(feats, jdt), jnp.asarray(rois))
        want_df, want_dr = vjp(jnp.asarray(g, jdt))
    want_df = np.asarray(want_df.astype(jnp.float32))
    assert not np.asarray(want_dr).any()
    f = torch.from_numpy(feats).to(tdt)[None].requires_grad_(True)
    r = torch.from_numpy(rois)[None].requires_grad_(True)
    out = troi.roi_align_int8_batched(f, r, SCALE, 14, 2)
    out.backward(torch.from_numpy(g).to(tdt)[None])
    assert f.grad.dtype == tdt and r.grad is None
    got = f.grad[0].float().numpy()
    err = np.abs(got - want_df).max() / np.abs(want_df).max()
    print(f"int8 RoIAlign backward, {dtype}: {err:.3g} of the largest entry")
    assert err <= BWD_TOL[dtype]


def test_quant_roi_pool_boxes_matches_jax(rng):
    """``OpenVocabularyRCNN(quant_roi=True).pool_boxes`` (K5 → res5 → mean
    pool) against JAX's ``clone(quant_roi=True)`` from the same converted
    weights. The int8 crops are equal; res5 sums in f32 in another order."""
    jmodel, _, _, variables, shared = tiny_pair()
    tmodel = shared.clone(quant_convs=False)   # tiny_pair's model is cached
    tmodel.quant_roi = True
    feats = rng.randn(2, 4, 8, 1024).astype(np.float32)
    rois = random_rois(rng, 2, 6)
    with jax.disable_jit():
        want = _apply((jmodel.clone(quant_roi=True), None, None, variables,
                       None),
                      "pool_boxes", feats, rois)
    with torch.no_grad():
        got = tmodel.pool_boxes(torch.from_numpy(feats),
                                torch.from_numpy(rois)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert tmodel.clone(quant_convs=True).quant_roi and not shared.quant_roi


def test_k5b_launcher_raises_on_cpu_tensors():
    """K5b's launcher refuses CPU tensors before it builds or launches
    anything: only the dispatch (``roi_align_int8_backward``) takes the
    plain version, and only for a CPU tensor."""
    from coin_tpu_torch.kernels import build
    from coin_tpu_torch.kernels.roi_align import roi_align_int8_backward_cuda
    loaded = dict(build._libs)
    g = torch.zeros((1, 2, 7, 7, 8))
    rois = torch.tensor([[[0.0, 0.0, 32.0, 32.0], [8.0, 8.0, 40.0, 24.0]]])
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_int8_backward_cuda(g, rois, (1, 4, 4, 8), torch.float32,
                                     SCALE, 7, 2)
    assert build._libs == loaded


def test_k5_integer_requantisation_equals_the_float_division():
    """K5 requantises the first contraction's s32 sum t in integers,
    sign(t) ((2 |t| + 127) div 254) clipped to 127
    (csrc/roi_align_int8.cu ``requant``), where the JAX source and the
    plain version compute clip(rint(f32(t) / 127), +-127): equal for every
    |t| < 2**20, which holds the reachable |t| <= 129 x 127."""
    t = np.arange(-(2 ** 20) + 1, 2 ** 20, dtype=np.int64)
    want = np.clip(np.rint(t.astype(np.float32) / np.float32(127.0)),
                   -127, 127).astype(np.int64)
    got = np.sign(t) * np.minimum((2 * np.abs(t) + 127) // 254, 127)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        troi._requant(torch.from_numpy(t).double()).long().numpy(), want)
    assert 129 * 127 < 2 ** 20


def test_k8_weight_split_matches_numpy_mirror(rng):
    """K8's weights split into TF32 parts (kernels/deform_conv
    ``split_weights_plain``, the plain version of the kernel's split):
    (3, 3, Cin, Cout) → (9, Cout, Cin), hi rounded to nearest with ties away
    from zero onto 10 mantissa bits (its low 13 bits 0), lo = w − hi rounded
    alike, against a numpy mirror of ``cvt.rna.tf32.f32``; hi + lo gives w
    back within 2**-22 |w|. Ties and a value that rounds up into the next
    binade are among the weights."""
    from coin_tpu_torch.kernels.deform_conv import split_weights_plain
    w = (rng.randn(3, 3, 32, 128) / 48).astype(np.float32)
    bits = w.view(np.uint32)
    bits[0, 0, 0, :4] = [0x3F801000, 0xBF803000, 0x3F800FFF, 0x3FFFF000]

    def rna(a):
        b = a.view(np.uint32).astype(np.uint64)
        return ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)

    wt = w.reshape(9, 32, 128).transpose(0, 2, 1)
    hi_want = rna(np.ascontiguousarray(wt))
    lo_want = rna(wt - hi_want)
    hi, lo = split_weights_plain(torch.from_numpy(w))
    assert hi.shape == lo.shape == (9, 128, 32)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  hi_want.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32),
                                  lo_want.view(np.uint32))
    assert not (hi.numpy().view(np.uint32) & 0x1FFF).any()
    assert hi[0, 0, 0] == np.float32(1.0 + 2.0 ** -10)     # a tie, away
    assert hi[0, 3, 0] == np.float32(2.0)                   # next binade
    err = np.abs(wt.astype(np.float64) - hi.double().numpy()
                 - lo.double().numpy())
    assert (err <= 2.0 ** -22 * np.abs(wt)).all()
