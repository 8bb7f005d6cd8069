"""Parity of the strong and weak views (K4's plain version,
``coin_tpu_torch.data.augment.preprocess_batch``) with the JAX package's
``preprocess_batch`` on the CPU.

JAX draws the augmentation's random values inside the function; the port
takes them as a (B, 9) tensor. ``jax_augment_draws`` reads them out of the
same key the JAX function splits, so both sides see the same values. Every
combination of the four gates is also forced, against JAX's own stages
(jitter, gray, blur, solarize) applied in order. Tolerance: 1e-5 on the
normalised views (f32; the canvas mean, the gray dot products and the
banded blur sum in another order).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coin_tpu.data import augment as jaug
from coin_tpu_torch.data import augment as taug
from coin_tpu_torch.engine import step_builder as tsb
from tests.test_torch_models import two_torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def jax_augment_draws(rng_aug, batch: int) -> np.ndarray:
    """(batch, 9) values that ``coin_tpu.data.augment.preprocess_batch``
    draws from ``rng_aug``: the four gate uniforms, b, c, s, hue, σ."""
    rows = []
    for key in jax.random.split(rng_aug, batch):
        k1, _, k3, _, p1, p2, p3, p4 = jax.random.split(key, 8)
        kb, kc, ks, kh, _ = jax.random.split(k1, 5)
        u = lambda k, lo=0.0, hi=1.0: float(jax.random.uniform(
            k, (), minval=lo, maxval=hi))
        rows.append([u(p1), u(p2), u(p3), u(p4), u(kb, 0.6, 1.4),
                     u(kc, 0.6, 1.4), u(ks, 0.6, 1.4), u(kh, -0.1, 0.1),
                     u(k3, 0.1, 2.0)])
    return np.asarray(rows, np.float32)


def _images(rng, b=2, h=24, w=40):
    """Blocky images with edges, so the blur and the canvas edge matter."""
    cells = rng.randint(0, 256, (b, h // 4, w // 4, 3))
    return cells.repeat(4, 1).repeat(4, 2).astype(np.uint8)


def test_preprocess_batch_matches_jax(rng):
    images = _images(rng, b=4)
    key = jax.random.key(11)
    want_s, want_w = jaug.preprocess_batch(jnp.asarray(images), key)
    draws = jax_augment_draws(key, 4)
    got_s, got_w = taug.preprocess_batch(torch.from_numpy(images),
                                         torch.from_numpy(draws))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("gates", list(itertools.product((0, 1), repeat=4)),
                         ids=lambda g: "".join(map(str, g)))
def test_every_gate_combination_matches_jax_stages(rng, gates):
    """Gates forced (jitter, gray, blur, solarize); the other values drawn
    by JAX from per-stage keys."""
    images = _images(rng)
    keys = jax.random.split(jax.random.key(sum(g << i for i, g in
                                               enumerate(gates))), 2)
    want = []
    draws = []
    for img, key in zip(images, keys):
        k_jit, k_blur = jax.random.split(key)
        x = jnp.asarray(img, jnp.float32) / 255.0
        if gates[0]:
            x = jaug._color_jitter(x, k_jit)
        if gates[1]:
            x = jaug._grayscale(x)
        if gates[2]:
            x = jaug._gaussian_blur(x, k_blur)
        if gates[3]:
            x = jaug._solarize(x)
        want.append(np.asarray((x - jaug.CLIP_MEAN) / jaug.CLIP_STD))
        kb, kc, ks, kh, _ = jax.random.split(k_jit, 5)
        u = lambda k, lo, hi: float(jax.random.uniform(k, (), minval=lo,
                                                       maxval=hi))
        # a gate is on when its uniform is below p (0.8, 0.2, 0.5, 0.2)
        draws.append([0.0 if g else 0.99 for g in gates]
                     + [u(kb, 0.6, 1.4), u(kc, 0.6, 1.4), u(ks, 0.6, 1.4),
                        u(kh, -0.1, 0.1), u(k_blur, 0.1, 2.0)])
    got, weak = taug.preprocess_batch(
        torch.from_numpy(images), torch.tensor(draws, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.stack(want), **TOL)
    np.testing.assert_allclose(
        weak.numpy(), np.asarray(jaug.normalize_batch(jnp.asarray(images))),
        **TOL)


def test_draw_augment_ranges():
    """The port's own draws follow the JAX distributions' supports."""
    d = taug.draw_augment(torch.Generator().manual_seed(0), 4096)
    lo = torch.tensor([0, 0, 0, 0, 0.6, 0.6, 0.6, -0.1, 0.1])
    hi = torch.tensor([1, 1, 1, 1, 1.4, 1.4, 1.4, 0.1, 2.0])
    assert bool(((d >= lo) & (d < hi)).all())
    on = (d[:, :4] < torch.tensor(taug.GATE_P)).float().mean(0)
    np.testing.assert_allclose(on.numpy(), taug.GATE_P, atol=0.03)


def test_strong_only_matches_both_views_and_jax(rng):
    """``weak=False`` gives the default call's strong view bit for bit and
    JAX's strong view, and no weak view."""
    images = _images(rng, b=4)
    key = jax.random.key(11)
    want_s, _ = jaug.preprocess_batch(jnp.asarray(images), key)
    draws = torch.from_numpy(jax_augment_draws(key, 4))
    both_s, _ = taug.preprocess_batch(torch.from_numpy(images), draws)
    only_s, weak = taug.preprocess_batch(torch.from_numpy(images), draws,
                                         weak=False)
    assert weak is None and torch.equal(only_s, both_s)
    np.testing.assert_allclose(only_s.numpy(), np.asarray(want_s), **TOL)


def test_cached_steps_skip_the_weak_view(monkeypatch):
    """The live step asks ``preprocess_batch`` for both views; the cached
    flavours, which drop the weak view as the JAX steps do, for the strong
    view alone."""
    asked = []

    class Stop(Exception):
        pass

    def recorder(images_u8, draws, weak=True):
        asked.append(weak)
        raise Stop

    monkeypatch.setattr(tsb, "preprocess_batch", recorder)
    steps = tsb.build_adaptation_steps(torch.zeros((2, 4), dtype=torch.long),
                                       None, None, tsb.StepHyper(burn_up=1))
    draws = tsb.StepDraws(augment=torch.zeros((1, 9)), rpn=None, roi=None)
    images = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    for step, offline in zip(steps, ((), (None,), (None,))):
        with pytest.raises(Stop):
            step(None, images, None, None, None, *offline, draws=draws)
    assert asked == [True, False, False]


def test_augment_launcher_raises_on_cpu_tensors():
    """K4's launcher refuses CPU tensors before it builds or launches
    anything: only ``preprocess_batch`` takes the plain version, and only
    for a CPU tensor."""
    from coin_tpu_torch.kernels import build
    from coin_tpu_torch.kernels.augment import augment_cuda
    loaded = dict(build._libs)
    images = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    params = taug.augment_params(torch.zeros((1, 9)))
    for weak in (True, False):
        with pytest.raises(ValueError, match="CUDA"):
            augment_cuda(images, params, taug.CLIP_MEAN, taug.CLIP_STD, weak)
    assert build._libs == loaded
