"""Parity of coin_tpu_torch's ops with the JAX package's on the CPU: box
algebra, greedy NMS (K3's plain version, and its division-free IoU test
against the quotient's), RoIAlign (K1's) and input normalisation (K4n's),
plus the import guard and the kernel-or-raise contract of the CUDA
launchers. The kernels themselves are held to these plain versions on the
card by tests/test_torch_kernels_cuda.py.

Tolerances: box ops, RoIAlign and normalisation agree to rtol = atol =
1e-5 in f32 (the same arithmetic, summed in another order; normalisation
also bit for bit with JAX run op by op); NMS keep masks and the IoU
tests' verdicts are equal.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coin_tpu.data import augment as jaug
from coin_tpu.ops import boxes as jboxes
from coin_tpu.ops import nms as jnms
from coin_tpu.ops import roi_align as jroi
from coin_tpu_torch.data import augment as taug
from coin_tpu_torch.ops import boxes as tboxes
from coin_tpu_torch.ops import nms as tnms
from coin_tpu_torch.ops import roi_align as troi
from tests.test_torch_models import two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def random_boxes(rng, n, size=100.0, min_wh=1.0, max_wh=40.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(min_wh, max_wh, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ----------------------------------------------------------------- boxes
@pytest.mark.parametrize("fn", ["area", "pairwise_iou", "pairwise_iou_plus1",
                                "encode_deltas", "decode_deltas"])
def test_box_ops_match_jax(rng, fn):
    a = random_boxes(rng, 30)
    b = random_boxes(rng, 20)
    b[:3] = a[:3]                      # exact overlaps
    b[3, 2:] = b[3, :2]                # degenerate box
    if fn == "area":
        args = (a,)
    elif fn in ("pairwise_iou", "pairwise_iou_plus1"):
        args = (a, b)
    elif fn == "encode_deltas":
        args = (a[:20], b)
    else:
        d = rng.randn(30, 4).astype(np.float32)
        d[:5, 2:] = 8.0                # beyond the log(1000/16) clamp
        args = (a, d)
    kw = {"weights": (10.0, 10.0, 5.0, 5.0)} if "deltas" in fn else {}
    want = np.asarray(getattr(jboxes, fn)(*map(jnp.asarray, args), **kw))
    got = getattr(tboxes, fn)(*map(torch.from_numpy, args), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------------------------- NMS
def _nms_case(rng, case):
    """(boxes, scores, valid, classes, plus1) of one image, or of a batch
    of two images where the case is about one image beside another."""
    if case in ("empty_in_batch", "one_in_batch"):
        # an image with no valid box, or with one, beside a random image
        cases = [_nms_case(rng, "random") for _ in range(2)]
        boxes, scores, valid = (np.stack([c[i] for c in cases])
                                for i in range(3))
        valid[1] = False
        if case == "one_in_batch":
            valid[1, 17] = True
        return boxes, scores, valid, None, False
    if case == "chain":
        # box k overlaps box k + 1 above the threshold (IoU 7/13) and box
        # k + 2 below it (4/16), in score order across 64-row tiles: box k
        # removes box k + 1, which, removed, must not remove box k + 2
        n = 200
        x = 3.0 * np.arange(n, dtype=np.float32)
        boxes = np.stack([x, np.zeros(n, np.float32), x + 10.0,
                          np.full(n, 10.0, np.float32)], -1)
        scores = np.linspace(1.0, 0.1, n).astype(np.float32)
        return boxes, scores, np.ones(n, bool), None, False
    n = {"large": 600, "ragged": 131}.get(case, 80)
    boxes = random_boxes(rng, n, size=60.0, min_wh=10.0)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = np.ones(n, bool)
    classes = None
    plus1 = case == "plus1"
    if case == "ragged":
        valid[[5, 77]] = False           # 129 valid rows: past two tiles
    if case == "ties":
        scores = np.round(scores * 4) / 4          # many equal scores
        boxes[10:20] = boxes[0]                    # identical boxes
    if case == "invalid":
        valid[rng.uniform(size=n) < 0.3] = False
        scores[~valid] = 5.0                       # must not matter
    if case == "degenerate":
        boxes[::7, 2] = boxes[::7, 0]              # zero width
        boxes[::11, 3] = boxes[::11, 1] - 1.0      # negative height
    if case in ("classes", "large"):
        classes = rng.randint(0, 4, n).astype(np.int32)
    return boxes, scores, valid, classes, plus1


@pytest.mark.parametrize("case", ["random", "ties", "invalid", "degenerate",
                                  "classes", "plus1", "large", "chain",
                                  "ragged", "empty_in_batch", "one_in_batch"])
def test_nms_keep_mask_matches_jax(rng, case):
    boxes, scores, valid, classes, plus1 = _nms_case(rng, case)
    thr = 0.5
    # JAX's nms_keep_mask takes one image
    want = np.stack([np.asarray(jnms.nms_keep_mask(
        jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), thr,
        classes=None if classes is None else jnp.asarray(classes),
        plus1=plus1)) for b, s, v in zip(boxes.reshape(-1, *boxes.shape[-2:]),
                                          scores.reshape(-1, scores.shape[-1]),
                                          valid.reshape(-1, valid.shape[-1]))
    ]).reshape(valid.shape)
    got = tnms.nms_keep_mask(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(valid), thr,
        classes=None if classes is None else torch.from_numpy(classes),
        plus1=plus1).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()


def test_nms_keep_mask_batched_equals_per_image(rng):
    """The batched call (one kernel launch on the card) keeps, per image,
    what the JAX per-image call keeps; the class offset uses each image's
    own valid boxes."""
    cases = [_nms_case(rng, c) for c in ("classes", "invalid")]
    boxes = np.stack([c[0] for c in cases])
    boxes[1] *= 3.0                               # other coordinate range
    scores = np.stack([c[1] for c in cases])
    valid = np.stack([c[2] for c in cases])
    classes = rng.randint(0, 3, scores.shape).astype(np.int32)
    got = tnms.nms_keep_mask(*map(torch.from_numpy, (boxes, scores, valid)),
                             0.6, classes=torch.from_numpy(classes)).numpy()
    for i in range(2):
        want = np.asarray(jnms.nms_keep_mask(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
            jnp.asarray(valid[i]), 0.6, classes=jnp.asarray(classes[i])))
        np.testing.assert_array_equal(got[i], want)


def _near_threshold_pairs(rng, thr):
    """(inter, union) f32 pairs whose quotient lies around ``thr``: random
    pairs, pairs within two ulps of the rounding boundary above thr, unions
    of 0 and below, and unions outside the range where the test decides
    without the division."""
    n = 100000
    inter = rng.uniform(0, 100, n).astype(np.float32)
    union = (inter + rng.uniform(0, 100, n)).astype(np.float32)
    u = rng.uniform(1.0, 1e6, 4000).astype(np.float32)
    h = tnms.threshold_split(thr)[1]
    mid = (np.float64(np.float32(thr)) + h) * u.astype(np.float64)
    near = mid.astype(np.float32)
    steps = [near]
    for _ in range(2):
        steps = ([np.nextafter(steps[0], np.float32(0))] + steps
                 + [np.nextafter(steps[-1], np.float32(np.inf))])
    inter = np.concatenate([inter] + steps + [
        np.float32([0.0, 3.0, 2.0, 1e-36, 7e-36, 7e30, 0.7e31])])
    union = np.concatenate([union] + [u] * len(steps) + [
        np.float32([0.0, 0.0, -4.0, 1e-35, 1e-35, 1e31, 1e31])])
    return torch.from_numpy(inter), torch.from_numpy(union)


@pytest.mark.parametrize("thr", [0.5, 0.6, 0.7])
def test_nms_division_free_iou_test_equals_the_quotient(rng, thr):
    """K3's IoU test without the division (``iou_decides``, the kernel's
    ``suppresses`` in PyTorch) against ``inter / union > thr`` rounded as
    the plain version rounds it: identical over 10**5 random pairs, pairs
    on the rounding boundary of the threshold and unions outside the range
    where it decides, which take the division; it decides every pair with
    a union in that range."""
    inter, union = _near_threshold_pairs(rng, thr)
    want = torch.where(union > 0, inter / union,
                       torch.zeros_like(inter)) > np.float32(thr)
    assert torch.equal(tnms.iou_exceeds(inter, union, thr), want)
    decided, verdict = tnms.iou_decides(inter, union, thr)
    in_range = (union >= tnms.threshold_split(thr)[2]) & (union <= 2.0 ** 100)
    assert torch.equal(decided, in_range)
    assert torch.equal(verdict[decided & (union > 0)],
                       want[decided & (union > 0)])
    boundary = slice(100000, len(inter) - 7)
    assert 0 < int(want[boundary].sum()) < len(inter) - 100007
    assert not bool(decided[-4:].any())


def _at_threshold_pairs(rng, thr):
    """(inter, union) f32 pairs whose rounded quotient lands on f32(thr), on
    the floats either side of it and a few ulps around them (inter from
    each target times a random union, then two ulps either way), random
    pairs, unions of 0 and below, and unions outside the range where the
    test decides without the division (the last four)."""
    t = np.float32(thr)
    targets = [np.nextafter(t, np.float32(0)), t,
               np.nextafter(t, np.float32(np.inf))]
    u = rng.uniform(1.0, 1e6, 3000).astype(np.float32)
    inter, union = [rng.uniform(0, 100, 20000).astype(np.float32)], []
    union.append((inter[0] + rng.uniform(0, 100, 20000)).astype(np.float32))
    for q in targets:
        base = (np.float64(q) * u.astype(np.float64)).astype(np.float32)
        for k in range(-2, 3):
            x = base
            for _ in range(abs(k)):
                x = np.nextafter(x, np.float32(np.inf if k > 0 else 0))
            inter.append(x)
            union.append(u)
    inter.append(np.float32([0.0, 3.0, 2.0, 1e-36, 7e-36, 7e30, 0.7e31]))
    union.append(np.float32([0.0, 0.0, -4.0, 1e-35, 1e-35, 1e31, 1e31]))
    return np.concatenate(inter), np.concatenate(union)


@pytest.mark.parametrize("thr", [0.9, 0.95, 1.0])
def test_iou_at_least_equals_the_quotient(rng, thr):
    """K11's join test (``iou_at_least``: K3's division-free test at thr-,
    the f32 just below thr) against numpy's correctly rounded f32 quotient
    ``inter / union >= thr`` (0 >= thr where union <= 0): identical on
    pairs whose quotient lands on thr and on either side of it, on random
    pairs and on unions outside the range where the test decides; it
    decides every pair with a union in that range."""
    inter, union = _at_threshold_pairs(rng, thr)
    q = np.divide(inter, union, out=np.zeros_like(inter), where=union > 0)
    t = np.float32(thr)
    want = q >= t
    got = tnms.iou_at_least(torch.from_numpy(inter),
                            torch.from_numpy(union), thr).numpy()
    np.testing.assert_array_equal(got, want)
    below = tnms.threshold_split_at_least(thr)
    assert below[0] == np.nextafter(t, np.float32(0)) and below[3]
    decided, verdict = tnms.iou_decides(torch.from_numpy(inter),
                                        torch.from_numpy(union), below[0])
    decided, verdict = decided.numpy(), verdict.numpy()
    assert np.array_equal(decided, (union >= below[2]) & (union <= 2.0 ** 100))
    assert np.array_equal(verdict[decided], want[decided])
    assert not decided[-4:].any()
    for target in (np.nextafter(t, np.float32(0)), t,
                   np.nextafter(t, np.float32(np.inf))):
        assert (q == target).any(), target


# -------------------------------------------------------------- RoIAlign
@pytest.mark.parametrize("hw", [(13, 21), (21, 13)], ids=["w>=h", "w<h"])
def test_roi_align_matches_jax(rng, hw):
    h, w = hw
    feats = rng.randn(h, w, 6).astype(np.float32)
    rois = random_boxes(rng, 24, size=16.0 * max(h, w), max_wh=200.0)
    rois[0] = [-40.0, -30.0, 60.0, 50.0]                  # partly outside
    rois[1] = [16.0 * w - 30, 16.0 * h - 20, 16.0 * w + 90,
               16.0 * h + 70]                             # past far edge
    rois[2] = [33.0, 41.0, 33.5, 41.2]                    # tiny
    rois[3] = [50.0, 50.0, 50.0, 50.0]                    # empty
    want = np.asarray(jroi.roi_align(jnp.asarray(feats), jnp.asarray(rois),
                                     1.0 / 16.0, 14, 2))
    got = troi.roi_align(torch.from_numpy(feats), torch.from_numpy(rois),
                         1.0 / 16.0, 14, 2).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_roi_align_batched_matches_jax(rng):
    feats = rng.randn(2, 9, 12, 4).astype(np.float32)
    rois = np.stack([random_boxes(rng, 5, size=150.0) for _ in range(2)])
    want = np.asarray(jroi.roi_align_batched(
        jnp.asarray(feats), jnp.asarray(rois), 1.0 / 16.0, 7, 2))
    got = troi.roi_align_batched(torch.from_numpy(feats),
                                 torch.from_numpy(rois), 1.0 / 16.0, 7,
                                 2).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", ["below_one_pixel", "larger_than_map",
                                  "off_the_image"])
def test_roi_align_footprints_match_jax(rng, case):
    """K1's plain version against JAX's roi_align_batched in f32 at the
    RoIs that bound the kernel's per-RoI walk: RoIs narrower than one
    feature pixel (every cell's samples on the same two or three taps),
    RoIs larger than the map (the samples past its edges weigh 0 or clamp)
    and RoIs wholly off the image (every sample weighs 0), each mixed with
    ordinary RoIs, at 1, 2 and 3 samples; the forward's twin of
    test_torch_train_ops.py::test_roi_align_backward_footprints_match_jax_vjp."""
    h, w = 11, 17
    rois = np.stack([random_boxes(rng, 6, size=16.0 * w, max_wh=120.0)
                     for _ in range(2)])
    if case == "below_one_pixel":
        rois[:, :4, 2:] = rois[:, :4, :2] + rng.uniform(0.3, 14.0, (2, 4, 2))
    elif case == "larger_than_map":
        rois[:, 0] = [-50.0, -40.0, 16.0 * w + 60, 16.0 * h + 30]
        rois[:, 1] = [-300.0, 20.0, 16.0 * w + 400, 16.0 * h + 250]
    else:
        rois[:, 0] = [-400.0, -300.0, -100.0, -60.0]
        rois[:, 1] = [16.0 * w + 40, 16.0 * h + 40, 16.0 * w + 200,
                      16.0 * h + 90]
    feats = rng.randn(2, h, w, 8).astype(np.float32)
    for sampling in (1, 2, 3):
        want = np.asarray(jroi.roi_align_batched(
            jnp.asarray(feats), jnp.asarray(rois), 1 / 16, 7, sampling))
        got = troi.roi_align_batched(torch.from_numpy(feats),
                                     torch.from_numpy(rois), 1 / 16, 7,
                                     sampling).numpy()
        np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------------------- normalise
def test_normalize_batch_matches_jax(rng):
    images = rng.randint(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    images[0, 0, 0] = [0, 255, 128]
    want = np.asarray(jaug.normalize_batch(jnp.asarray(images)))
    got = taug.normalize_batch(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("constants", ["clip", "imagenet"])
def test_normalize_batch_every_value_matches_jax(constants):
    """K4n's plain version (the kernel equals it bit for bit on the card)
    over all 256 values of each channel, CLIP's constants and ImageNet's
    (the GDINO and GLIP teachers'): equal to JAX's run op by op, whose
    divisions are correctly rounded, and within TOL of JAX's compiled
    function, which multiplies by reciprocals."""
    from coin_tpu.models.gdino_detector import GDINODetector
    from coin_tpu_torch.models.gdino_detector import (IMAGENET_MEAN,
                                                      IMAGENET_STD)
    images = np.repeat(np.arange(256, dtype=np.uint8)[None, :, None, None],
                       3, -1)
    if constants == "clip":
        mean, std, jfn = taug.CLIP_MEAN, taug.CLIP_STD, jaug.normalize_batch
    else:
        mean, std = IMAGENET_MEAN, IMAGENET_STD
        assert np.array_equal(np.float32(mean), GDINODetector.IMAGENET_MEAN)
        assert np.array_equal(np.float32(std), GDINODetector.IMAGENET_STD)

        def jfn(x):    # GDINODetector.detect's normalisation (:230-231)
            img = x.astype(jnp.float32) / 255.0
            return (img - GDINODetector.IMAGENET_MEAN) \
                / GDINODetector.IMAGENET_STD
    got = taug.normalize_batch(torch.from_numpy(images), mean, std).numpy()
    with jax.disable_jit():
        op_by_op = np.asarray(jfn(jnp.asarray(images)))
    np.testing.assert_array_equal(got, op_by_op)
    compiled = np.asarray(jax.jit(jfn)(jnp.asarray(images)))
    np.testing.assert_allclose(got, compiled, **TOL)


# ------------------------------------------- package and device contract
def test_port_imports_nothing_of_jax_or_coin_tpu():
    """Every module of coin_tpu_torch (the K10, CLIP, pre-train, CLI, A/B
    harness, native decoder, loader, zoom-merge, parallel and utils
    modules named) imports
    in a fresh interpreter without pulling in jax, flax or coin_tpu."""
    code = """
import pkgutil, importlib, sys
import coin_tpu_torch
names = [m.name for m in pkgutil.walk_packages(coin_tpu_torch.__path__,
                                               'coin_tpu_torch.')]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'coin_tpu'))
assert not bad, bad
assert len(names) >= 20, names
new = {'coin_tpu_torch.' + m for m in (
    'ops.preprocess', 'kernels.preprocess', 'tools.bench_preprocess',
    'tools.bench', 'models.tokenizer', 'models.convert',
    'models.clip_scorer', 'engine.clip_setup', 'engine.pre_train',
    'tools.train_net', 'evaluation.testing', 'utils.setup',
    'engine.oracle', 'evaluation.dump', 'tools.validate', 'tools.ab_compare', 'data.voc',
    'native', 'data.loader', 'engine.zoom_merge', 'parallel',
    'parallel.multihost', 'parallel.mesh_utils', 'utils.profiling',
    'utils.visualize')}
assert new <= set(names), new - set(names)
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_counts_kernels_through_dropped_records(monkeypatch):
    """chip_smoke.kernels_per_call reads the most launches a call that the
    profiler recorded over its traces of 20 calls, rounded up: a trace
    that loses records at its end (as the card's profiler does now and
    then: 58 of K10a's 60 kernels in one run) does not fail a count, and
    an extra launch a call still shows."""
    from types import SimpleNamespace

    import chip_smoke
    from torch.autograd import DeviceType

    def traces(counts):
        counts = iter(counts)

        class Profile:
            def __init__(self, activities):
                self.n = next(counts)

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def key_averages(self):
                return [SimpleNamespace(device_type=DeviceType.CUDA,
                                        self_device_time_total=1.0,
                                        count=self.n, key="resize_rows"),
                        SimpleNamespace(device_type=DeviceType.CUDA,
                                        self_device_time_total=1.0,
                                        count=20, key="memcpy")]
        monkeypatch.setattr(torch.profiler, "profile", Profile)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    count = chip_smoke.kernels_per_call
    traces([58, 57])
    assert count(torch, lambda: None, ("resize",)) == 3
    traces([60, 60])
    assert count(torch, lambda: None, ("resize",)) == 3
    traces([79, 78])
    assert count(torch, lambda: None, ("resize",)) == 4
    traces([58, 60])
    assert count(torch, lambda: None) == 4


def test_entry_point_without_device_raises_without_cuda(monkeypatch):
    from coin_tpu_torch.config import load_config
    from coin_tpu_torch.engine.pipelines import build_detector
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(os.path.join(REPO, "configs/coin/GDINO/foggy_fast.yaml"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg, 8)


@pytest.mark.parametrize("which", ["roi_align", "nms", "normalize",
                                   "quantize", "quantize_weight_pair",
                                   "qconv", "qconv_wgrad",
                                   "window_attention", "ms_deform",
                                   "fusion_nms", "roi_align_int8",
                                   "roi_align_int8_bwd", "self_cluster",
                                   "resize_bilinear", "normalize_flip"])
def test_cuda_launchers_refuse_cpu_tensors(which):
    """A launcher never falls back: a CPU tensor is refused before any
    build or launch."""
    from coin_tpu_torch.kernels import qconv as kq
    from coin_tpu_torch.kernels.fusion_nms import fusion_nms_cuda
    from coin_tpu_torch.kernels.ms_deform import ms_deform_cuda
    from coin_tpu_torch.kernels.window_attention import \
        window_attention_cuda
    from coin_tpu_torch.kernels.nms import nms_sorted_cuda
    from coin_tpu_torch.kernels.normalize import normalize_cuda
    from coin_tpu_torch.kernels.dedup import self_cluster_cuda
    from coin_tpu_torch.kernels.preprocess import (normalize_flip_cuda,
                                                   resize_bilinear_cuda)
    from coin_tpu_torch.kernels.roi_align import (
        roi_align_cuda, roi_align_int8_backward_cuda, roi_align_int8_cuda)
    s8 = torch.zeros(1, 4, 4, 16, dtype=torch.int8)
    one = torch.ones(1)
    call = {
        "quantize": lambda: kq.quantize_cuda(torch.zeros(1, 4, 4, 8), False),
        "qconv": lambda: kq.qconv_fwd_cuda(
            s8, torch.zeros(8, 3, 3, 16, dtype=torch.int8), one,
            torch.ones(8), 1, 1),
        "quantize_weight_pair": lambda: kq.quantize_weight_pair_cuda(
            torch.zeros(8, 16, 3, 3)),
        "qconv_wgrad": lambda: kq.qconv_wgrad_cuda(
            s8[0, 0], s8[0, 0], one, one, 1, 1, 4, 1),
        "roi_align": lambda: roi_align_cuda(torch.zeros(1, 4, 4, 8),
                                            torch.zeros(1, 2, 4), 1.0, 7, 2),
        "nms": lambda: nms_sorted_cuda(torch.zeros(1, 8, 4),
                                       torch.zeros(1, dtype=torch.int32),
                                       0.5, False),
        "normalize": lambda: normalize_cuda(
            torch.zeros(1, 2, 2, 3, dtype=torch.uint8), taug.CLIP_MEAN,
            taug.CLIP_STD),
        "window_attention": lambda: window_attention_cuda(
            torch.zeros(2, 49, 3, 2, 32), torch.zeros(169, 2),
            torch.zeros(49, 49, dtype=torch.int32), None),
        "ms_deform": lambda: ms_deform_cuda(
            torch.zeros(1, 5, 2, 8), torch.ones(1, 2, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), torch.zeros(1, 3, 2, 1, 4, 2),
            torch.zeros(1, 3, 2, 1, 4)),
        "roi_align_int8": lambda: roi_align_int8_cuda(
            torch.zeros(1, 4, 4, 8), torch.zeros(1, 2, 4), 1.0, 7, 2),
        "roi_align_int8_bwd": lambda: roi_align_int8_backward_cuda(
            torch.zeros(1, 2, 7, 7, 8), torch.zeros(1, 2, 4), (1, 4, 4, 8),
            torch.float32, 1.0, 7, 2),
        "self_cluster": lambda: self_cluster_cuda(
            torch.zeros(1, 8, 4), torch.ones(1, 8, dtype=torch.bool), 0.9),
        "resize_bilinear": lambda: resize_bilinear_cuda(
            torch.zeros(8, 8, 3), 0.5, (4, 4)),
        "normalize_flip": lambda: normalize_flip_cuda(
            torch.zeros(1, 2, 2, 3, dtype=torch.uint8), torch.zeros(
                1, dtype=torch.bool), taug.CLIP_MEAN, taug.CLIP_STD),
        "fusion_nms": lambda: fusion_nms_cuda(
            torch.zeros(1, 8, 4), torch.zeros(1, 8, 3),
            torch.zeros(1, 8, dtype=torch.int32),
            torch.zeros(1, 8, dtype=torch.bool), 0.6, 0, 0),
    }[which]
    with pytest.raises(ValueError, match="CUDA"):
        call()


# ------------------------------------------------------------- utils/
@pytest.mark.parametrize("labels", ["names", "classes", "none"])
def test_draw_detections_matches_jax(tmp_path, labels):
    """utils/visualize.draw_detections: the same image, pixel for pixel, as
    the JAX package's (boxes, colours by class, label text), given numpy
    arrays or tensors; the saved PNG reads back as the returned image."""
    from coin_tpu.utils.visualize import draw_detections as jdraw
    from coin_tpu_torch.utils.visualize import draw_detections
    rng = np.random.RandomState(3)
    image = rng.randint(0, 256, (60, 90, 3)).astype(np.uint8)
    xy = rng.uniform(0, 50, (9, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (9, 2))], 1)
    scores = rng.uniform(0, 1, 9).astype(np.float32)
    classes = np.arange(9) % 9
    kw = {"names": dict(scores=scores, classes=classes,
                        class_names=[f"c{i}" for i in range(9)]),
          "classes": dict(classes=classes), "none": {}}[labels]
    want = np.asarray(jdraw(image, boxes, **kw))
    got = draw_detections(image, boxes, save_path=str(tmp_path / "a.png"),
                          **kw)
    np.testing.assert_array_equal(np.asarray(got), want)
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  want)
    tkw = {k: torch.from_numpy(np.asarray(v)) if k != "class_names" else v
           for k, v in kw.items()}
    np.testing.assert_array_equal(np.asarray(draw_detections(
        torch.from_numpy(image), torch.from_numpy(boxes), **tkw)), want)


def test_iteration_timer_matches_jax(monkeypatch):
    """utils/profiling.IterationTimer: the JAX class's windows, averages
    and order of reads, under one patched perf_counter."""
    import coin_tpu.utils.profiling as jprof
    import coin_tpu_torch.utils.profiling as tprof
    ticks = iter(np.cumsum(np.random.RandomState(1).uniform(0.01, 1, 400)))
    clock = {"t": 0.0}
    monkeypatch.setattr(jprof.time, "perf_counter", lambda: clock["t"])
    timers = [jprof.IterationTimer(window=3), tprof.IterationTimer(window=3)]
    assert all(t.avg_iter == t.avg_data == 0.0 for t in timers)
    for step in range(7):
        for call in ("before_data", "after_data", "after_step"):
            clock["t"] = float(next(ticks))
            for t in timers:
                getattr(t, call)()
        if step == 3:   # a step without a data wait
            clock["t"] = float(next(ticks))
            for t in timers:
                t.after_step()
        j, p = timers
        assert list(p.iter_times) == list(j.iter_times)
        assert list(p.data_times) == list(j.data_times)
        assert p.avg_iter == j.avg_iter and p.avg_data == j.avg_data
    assert len(timers[1].iter_times) == 3


def test_trace_context_writes_a_chrome_trace(tmp_path):
    """utils/profiling.trace_context: a torch.profiler trace of the block,
    written as Chrome trace JSON that names the ops run inside it."""
    import json
    from coin_tpu_torch.utils.profiling import trace_context
    with trace_context(str(tmp_path / "trace")) as prof:
        torch.ones(8, 8).matmul(torch.ones(8, 8))
    assert prof is not None
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
