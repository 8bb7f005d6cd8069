"""The ZOOM and AUG collection views of the port against the JAX package's
on the CPU.

``center_zoom_box`` equals JAX's on every geometry tried. ``merge_zoom``
(host numpy; the port's ``ops/nms`` fusions on CPU tensors where JAX uses
its own) gives JAX's rows in JAX's order: the same classes exactly,
boxes, scores and probs within 1e-6 (f32 softmax and log in another
library), on the cases of ``tests/test_dedup_zoom.py`` and on a border
box fused, a class mismatch replaced, a same-class pair fused, an empty
zoom, no original box inside the zoom, a zoom box at the crop's border
over an original border box, and random scenes. Its ``stats`` count each
case.

``strong_view_u8``, the AUG view (K4's plain version with the identity
normalisation, times 255, truncated to uint8), against JAX's eager
``(vmap(strong_augment_single)(u8 / 255, keys) * 255).astype(uint8)`` of
``coin_tpu/engine/collect.py:93-97`` under the same draws: at most 1e-3 of
the bytes may differ, each by at most 1 (the gray mean sums in f64 in the
port and in f32 in JAX, and the blur sums in another order, so a product
near an integer may truncate the other way; measured: no byte differs).
With every gate off the view gives back every input value unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coin_tpu.data.augment import strong_augment_single
from coin_tpu.engine import zoom_merge as jzoom
from coin_tpu_torch.data import augment as taug
from coin_tpu_torch.engine import zoom_merge as tzoom
from tests.test_torch_augment import jax_augment_draws
from tests.test_torch_models import two_torch_threads  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("h,w,min_zoom", [
    (600, 1200, 320), (608, 1216, 320), (1216, 608, 320), (64, 85, 40),
    (85, 64, 40), (300, 200, 320), (333, 777, 100), (100, 100, 50),
    (101, 99, 31)])
def test_center_zoom_box_matches_jax(h, w, min_zoom):
    assert tzoom.center_zoom_box(h, w, min_zoom) \
        == jzoom.center_zoom_box(h, w, min_zoom)


def npdet(boxes, classes, scores, c1=3):
    """The detections of tests/test_dedup_zoom.py's ``npdet``."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    probs = np.full((len(boxes), c1), 0.1, np.float32)
    for i, (c, s) in enumerate(zip(classes, scores)):
        probs[i, c] = s
    return {"boxes": boxes, "scores": np.asarray(scores, np.float32),
            "classes": np.asarray(classes, np.int64), "probs": probs}


def _copy(det):
    return {k: v.copy() for k, v in det.items()}


def _merge_both(ori, zoom, xywh):
    stats = {}
    got = tzoom.merge_zoom(_copy(ori), _copy(zoom), xywh, stats=stats)
    want = jzoom.merge_zoom(_copy(ori), _copy(zoom), xywh)
    assert len(got["boxes"]) == len(want["boxes"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    for f in ("boxes", "scores", "probs"):
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_allclose(got[f], want[f], err_msg=f, **TOL)
    return got, stats


ZOOM_100 = (50, 50, 100, 100)     # the centre 100 x 100 of 200 x 200
CASES = {
    # tests/test_dedup_zoom.py:76-95
    "basic": (npdet([[0, 0, 40, 40], [60, 60, 90, 90]], [0, 1], [0.9, 0.8]),
              npdet([[61, 61, 91, 91], [110, 110, 130, 130]], [1, 0],
                    [0.85, 0.7]),
              dict(kept=1, fused=1, appended=1)),
    "unconfirmed_interior": (
        npdet([[60, 60, 90, 90]], [0], [0.9]),
        npdet([[120, 120, 140, 140]], [1], [0.8]),
        dict(dropped=1, appended=1)),
    # a border box (cut by the window) Bayesian-fused with its zoom match
    "border_fused": (npdet([[30, 60, 80, 90]], [1], [0.6]),
                     npdet([[50, 60, 80, 90]], [1], [0.9]),
                     dict(border=1, border_fused=1)),
    # the fusion would change the border box's class: left as it is
    "border_class_kept": (npdet([[30, 60, 80, 90]], [1], [0.35]),
                          npdet([[50, 60, 80, 90]], [2], [0.95]),
                          dict(border=1)),
    "class_mismatch": (npdet([[60, 60, 90, 90]], [0], [0.9]),
                       npdet([[61, 60, 91, 90]], [2], [0.7]),
                       dict(replaced=1)),
    "empty_zoom": (npdet([[60, 60, 90, 90], [0, 0, 10, 10]], [0, 1],
                         [0.9, 0.5]),
                   npdet([], [], []), dict(kept=2)),
    "nothing_inside": (npdet([[0, 0, 40, 40], [160, 0, 200, 30]], [0, 1],
                             [0.9, 0.5]),
                       npdet([[70, 70, 90, 95]], [1], [0.6]),
                       dict(kept=2, appended=1)),
    # a zoom box at the crop's border over an original border box is not
    # appended; one at the border over nothing is
    "border_zoom_excluded": (
        npdet([[20, 100, 80, 130]], [0], [0.8]),
        npdet([[51, 100, 70, 140], [52, 52, 60, 60]], [1, 2], [0.9, 0.6]),
        dict(border=1, appended=1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_merge_zoom_matches_jax(case):
    ori, zoom, counts = CASES[case]
    got, stats = _merge_both(ori, zoom, ZOOM_100)
    assert {k: v for k, v in stats.items() if v} == counts
    assert len(got["boxes"]) == sum(counts.get(k, 0) for k in (
        "kept", "border", "fused", "replaced", "appended"))


def _scene(rng, n, c1=4):
    """n rows around the centre 160 x 160 of a 400 x 400 image."""
    xy = rng.uniform(80, 300, (n, 2))
    wh = rng.uniform(8, 60, (n, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 400)], 1)
    probs = rng.dirichlet(np.ones(c1) * 0.3, n).astype(np.float32)
    return {"boxes": boxes.astype(np.float32),
            "scores": probs.max(1), "classes": probs.argmax(1),
            "probs": probs}


@pytest.mark.parametrize("seed", range(4))
def test_merge_zoom_random_scenes_match_jax(seed):
    """Random original rows and zoom rows, some of them jittered copies of
    originals inside the window (confirmations, either class)."""
    rng = np.random.RandomState(seed)
    xywh = tzoom.center_zoom_box(400, 400, 160)
    ori = _scene(rng, 40)
    pick = rng.choice(40, 15, replace=False)
    near = {k: v[pick].copy() for k, v in ori.items()}
    near["boxes"] += rng.uniform(-3, 3, near["boxes"].shape) \
        .astype(np.float32)
    swap = rng.rand(15) < 0.3
    near["classes"][swap] = (near["classes"][swap] + 1) % 4
    zoom = tzoom._cat(near, _scene(rng, 10))
    _, stats = _merge_both(ori, zoom, xywh)
    assert stats["kept"] and stats["border"] and stats["fused"] \
        and stats["appended"]


def test_strong_view_u8_matches_jax(rng):
    """The AUG view of collect_cloud: JAX splits jax.random.key(0) for the
    batch; the port takes the same draws."""
    b, h, w = 2, 64, 96
    cells = rng.randint(0, 256, (b, h // 4, w // 4, 3)) \
        .repeat(4, 1).repeat(4, 2)
    images = (cells // 2 + rng.randint(0, 8, (b, h, w, 3))).astype(np.uint8)
    keys = jax.random.split(jax.random.key(0), b)
    img = jnp.asarray(images).astype(jnp.float32) / 255.0
    aug = jax.vmap(strong_augment_single)(img, keys)
    want = np.asarray((aug * 255.0).astype(jnp.uint8))
    draws = jax_augment_draws(jax.random.key(0), b)
    got = taug.strong_view_u8(torch.from_numpy(images),
                              torch.from_numpy(draws))
    assert got.dtype == torch.uint8 and got.shape == images.shape
    d = np.abs(got.numpy().astype(int) - want.astype(int))
    assert (d != 0).mean() <= 1e-3 and d.max() <= 1
    assert (got.numpy() != images).mean() > 0.5     # the view augments


def test_strong_view_u8_with_every_gate_off_is_the_identity():
    values = torch.arange(256, dtype=torch.uint8)
    images = values.repeat(2, 3, 4, 1).reshape(2, 16, 64, 3).contiguous()
    draws = torch.ones((2, 9))          # every gate uniform above its p
    out = taug.strong_view_u8(images, draws)
    assert torch.equal(out, images)
