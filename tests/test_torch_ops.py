"""Parity of coin_tpu_torch's ops with the JAX package's on the CPU: box
algebra, greedy NMS (K3's plain version), RoIAlign (K1's) and input
normalisation (K4n's), plus the import guard and the kernel-or-raise
contract of the CUDA launchers. The kernels themselves are held to these
plain versions on the card by tests/test_torch_kernels_cuda.py.

Tolerances: box ops, RoIAlign and normalisation agree to rtol = atol =
1e-5 in f32 (the same arithmetic, summed in another order); NMS keep
masks are equal.
"""

import os
import subprocess
import sys

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
    n = {"large": 600}.get(case, 80)
    boxes = random_boxes(rng, n, size=60.0, min_wh=10.0)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = np.ones(n, bool)
    classes = None
    plus1 = case == "plus1"
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
                                  "classes", "plus1", "large"])
def test_nms_keep_mask_matches_jax(rng, case):
    boxes, scores, valid, classes, plus1 = _nms_case(rng, case)
    thr = 0.5
    want = np.asarray(jnms.nms_keep_mask(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thr,
        classes=None if classes is None else jnp.asarray(classes),
        plus1=plus1))
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


# ------------------------------------------------------------- normalise
def test_normalize_batch_matches_jax(rng):
    images = rng.randint(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    images[0, 0, 0] = [0, 255, 128]
    want = np.asarray(jaug.normalize_batch(jnp.asarray(images)))
    got = taug.normalize_batch(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------- package and device contract
def test_port_imports_nothing_of_jax_or_coin_tpu():
    """Every module of coin_tpu_torch (the K10 and CLIP modules named)
    imports in a fresh interpreter without pulling in jax, flax or
    coin_tpu."""
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
    'models.clip_scorer', 'engine.clip_setup')}
assert new <= set(names), new - set(names)
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


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
