"""K10, the port's device-side preprocessing (coin_tpu_torch.ops.preprocess:
``resize_bilinear`` K10a, ``normalize_flip`` K10b), against the JAX
package's coin_tpu.ops.preprocess on the CPU, where the public functions
run the plain versions; the kernels are held to the plain versions on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances. K10a: rtol 1e-5 and atol 1e-3 in 0-255 units. XLA contracts
the dense (H1, H0) and (W1, W0) matrices and sums all their terms in its
own order, the port's plain version sums in torch's; measured at most
6.1e-5 absolute (4.1e-7 relative) over the cases below, and the zero rows
and columns past the scaled extent are equal. K10b: 1e-5 as
tests/test_preprocess.py; measured 0 (the same three correctly rounded
operations; compiled XLA keeps the division by 255 here).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coin_tpu.ops import preprocess as jpre
from coin_tpu_torch.ops import preprocess as tpre
from coin_tpu_torch.tools import bench_preprocess

MEAN = bench_preprocess.MEAN
STD = bench_preprocess.STD
# f32(0.305): 100 x scale is exactly 30.5 in f32 (JAX rounds it half to
# even, to 30) and 30.500000715 in f64 (Python's round gives 31)
TIE = float(np.float32(0.305))


@pytest.mark.parametrize("h0,w0,scale,out_hw,dtype", [
    (40, 60, 0.5, (32, 48), "uint8"),
    (128, 256, 0.5859375, (80, 160), "uint8"),
    (128, 256, 0.5859375, (80, 160), "float32"),
    (20, 30, 1.5, (32, 48), "float32"),
    (20, 30, 1.5, (32, 40), "uint8"),
    (100, 150, TIE, (32, 48), "uint8"),
    (37, 53, 0.3, (16, 20), "float32"),
], ids=["down0.5", "foggy-u8", "foggy-f32", "up1.5-f32", "up1.5-cropped",
        "f32-tie", "down0.3"])
def test_resize_bilinear_matches_jax(rng, h0, w0, scale, out_hw, dtype):
    if dtype == "uint8":
        img = rng.randint(0, 256, (h0, w0, 3)).astype(np.uint8)
    else:
        img = rng.uniform(0, 255, (h0, w0, 3)).astype(np.float32)
    want = np.asarray(jpre.resize_bilinear(
        jnp.asarray(img), jnp.asarray(scale, jnp.float32), out_hw))
    got = tpre.resize_bilinear(torch.from_numpy(img), scale, out_hw)
    assert got.dtype == torch.float32 and got.shape == out_hw + (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)


def test_scaled_extent_rounds_the_f32_product_half_to_even():
    assert tpre.scaled_extent(100, TIE) == 30 == int(
        jnp.round(100 * jnp.asarray(TIE, jnp.float32)))
    assert round(100 * TIE) == 31          # the f64 product is past the tie
    img = np.full((100, 150, 3), 200, np.uint8)
    out = tpre.resize_bilinear(torch.from_numpy(img), TIE, (32, 48))
    assert (out[:30, :46] > 0).all() and (out[30:] == 0).all() \
        and (out[:, 46:] == 0).all()


@pytest.mark.parametrize("src,dst,scale", [(40, 32, 0.5), (1024, 608,
                                                          0.5859375),
                                            (30, 48, 1.5), (100, 32, TIE)])
def test_resize_matrix_matches_jax(src, dst, scale):
    want = np.asarray(jpre._resize_matrix(src, dst, jnp.asarray(scale)))
    got = tpre.resize_matrix(src, dst, scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("flip", [[True, False, True], [True, True, True]],
                         ids=["mixed", "all"])
def test_normalize_flip_matches_jax(rng, flip):
    imgs = rng.randint(0, 256, (3, 16, 20, 3)).astype(np.uint8)
    imgs[0, 0, 0] = [0, 255, 128]
    want = np.asarray(jpre.normalize_flip(
        jnp.asarray(imgs), jnp.asarray(flip), jnp.asarray(MEAN, jnp.float32),
        jnp.asarray(STD, jnp.float32)))
    got = tpre.normalize_flip(torch.from_numpy(imgs), torch.tensor(flip),
                              MEAN, STD).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the flagged images are the unflagged function of the mirrored ones
    plain = tpre.normalize_flip(torch.from_numpy(imgs[:, :, ::-1].copy()),
                                [False] * 3, MEAN, STD).numpy()
    for i, f in enumerate(flip):
        if f:
            np.testing.assert_array_equal(got[i], plain[i])


def test_bench_preprocess_runs_both_on_the_cpu_and_raises_without_cuda(
        monkeypatch, tmp_path):
    """The port's tool reports the JAX tool's keys and the resize's on
    ``--device cpu``; by default it needs the card and raises without
    one, as the public functions' CUDA launchers refuse CPU tensors
    (tests/test_torch_ops.py)."""
    out = tmp_path / "pre.json"
    rep = bench_preprocess.main(["--device", "cpu", "--iters", "1",
                                 "--batch", "1", "--out", str(out)])
    assert {"shape", "jnp_ms", "jnp_gbps", "note", "resize_shape",
            "resize_ms", "resize_gbps"} <= set(rep)
    assert rep["shape"] == [1, 608, 1216, 3] and rep["jnp_ms"] > 0
    assert rep["resize_shape"] == [1024, 2048, 3, 608, 1216]
    assert json.loads(out.read_text()) == rep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_preprocess.main(["--iters", "1"])
    assert os.path.exists(out)
