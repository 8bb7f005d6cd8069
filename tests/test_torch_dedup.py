"""coin_tpu_torch.ops.dedup (K11's plain version and the module around it)
and ``pipelines.shared_pool`` (TPU.TEACHER_SHARE_CROPS) against the JAX
package's ``coin_tpu.ops.dedup`` and ``coin_tpu.engine.pipelines`` on the
CPU.

Every comparison is exact: masks and indices are discrete, and the IoU is
the same sequence of correctly rounded f32 operations on both sides. The
boxes have real clusters (``chip_smoke.clustered_boxes``): exact
duplicates, chains whose ends do not overlap enough (the closure must be
transitive), invalid copies of members, zero-area boxes and singletons.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import chain_boxes, clustered_boxes
from coin_tpu.engine import pipelines as jpipe
from coin_tpu.ops import dedup as jdedup
from coin_tpu.ops.boxes import pairwise_iou
from coin_tpu.structures import Detections as JDetections
from coin_tpu_torch.engine import pipelines as tpipe
from coin_tpu_torch.ops import dedup as tdedup
from coin_tpu_torch.ops import nms as tnms
from coin_tpu_torch.structures import Detections
from tests.test_shared_pool import _PoolModel


def _dets(boxes, valid, rng):
    n = len(boxes)
    scores = rng.uniform(size=n).astype(np.float32)
    classes = np.where(valid, rng.randint(0, 3, n), -1).astype(np.int32)
    j = JDetections(jnp.asarray(boxes), jnp.asarray(scores),
                    jnp.asarray(classes), jnp.asarray(valid))
    t = Detections(torch.from_numpy(boxes), torch.from_numpy(scores),
                   torch.from_numpy(classes), torch.from_numpy(valid))
    return j, t


@pytest.mark.parametrize("thr", [0.9, 0.95, 0.5])
def test_self_cluster_index_matches_jax(thr):
    rng = np.random.RandomState(int(thr * 100))
    boxes, valid = zip(*[clustered_boxes(rng, 96, thr) for _ in range(2)])
    keep, rep = tdedup.self_cluster_index(torch.from_numpy(np.stack(boxes)),
                                          torch.from_numpy(np.stack(valid)),
                                          thr)
    for i, (b, v) in enumerate(zip(boxes, valid)):
        jkeep, jrep = jdedup.self_cluster_index(jnp.asarray(b),
                                                jnp.asarray(v), thr)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jkeep))
        np.testing.assert_array_equal(rep[i].numpy(), np.asarray(jrep))
        # the inputs hold clusters, and some member reaches its
        # representative only through the closure
        r = rep[i].numpy()
        assert (r != np.arange(len(b)))[v].any()
        iou = np.asarray(pairwise_iou(jnp.asarray(b), jnp.asarray(b)))
        assert any(iou[k, r[k]] < thr for k in np.flatnonzero(v)
                   if r[k] != k)


def _union_find_model(boxes, valid, thr, rng):
    """K11's algorithm (csrc/dedup.cu) in numpy: the edges of the upper
    triangle by its division-free test (``nms.iou_at_least``) on inter and
    union rounded as the kernel rounds them, joined in a shuffled order by
    hanging the larger of two roots below the smaller, then each row's
    root → (keep, rep)."""
    n = len(boxes)
    x1, y1, x2, y2 = (boxes[:, k] for k in range(4))
    w = np.maximum(np.minimum(x2[:, None], x2) - np.maximum(x1[:, None], x1),
                   np.float32(0))
    h = np.maximum(np.minimum(y2[:, None], y2) - np.maximum(y1[:, None], y1),
                   np.float32(0))
    inter = w * h
    area = (x2 - x1) * (y2 - y1)
    union = (area[:, None] + area) - inter
    edge = tnms.iou_at_least(torch.from_numpy(inter), torch.from_numpy(union),
                             thr).numpy()
    edge &= valid[:, None] & valid & np.triu(np.ones((n, n), bool), 1)
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            x = parent[x]
        return x
    for i, j in rng.permutation(np.argwhere(edge)):
        a, b = sorted((find(i), find(j)))
        parent[b] = a
    rep = np.array([find(i) for i in range(n)])
    return (rep == np.arange(n)) & valid, rep


def _hard_case(case, thr, rng):
    """(boxes, valid) of one hard case of the closure: n = 128 for the
    chain, 77 for the rest (JAX compiles its ops once a shape); the one row
    comes first, then 76 invalid rows."""
    def box(x, y, w, h):
        return [x, y, x + w, y + h]
    if case == "chain_reversed":
        return chain_boxes(128, thr)
    if case == "all_invalid":
        boxes, _ = clustered_boxes(rng, 77, thr)
        return boxes, np.zeros(77, bool)
    if case == "one_row":
        boxes, _ = clustered_boxes(rng, 77, thr)
        boxes[0] = [3.0, 4.0, 50.0, 60.0]
        return boxes, np.arange(77) == 0
    if case == "n_77":
        return clustered_boxes(rng, 77, thr)
    # pairs at IoU exactly f32(thr) (0.9 = 90 / 100, 0.95 = 190 / 200),
    # pairs just below it, and clustered boxes between them (n = 77)
    w = 10.0 if thr == 0.9 else 20.0
    rows = []
    for k in range(6):
        x = 200.0 * k
        rows += [box(x, 0.0, w, 10.0), box(x, 0.0, w - 1.0, 10.0),
                 box(x, 500.0, w, 10.0),
                 box(x, 500.0, np.nextafter(np.float32(w - 1.0), 0), 10.0)]
    boxes, valid = clustered_boxes(rng, 53, thr)
    boxes = np.concatenate([boxes + 2000.0, np.asarray(rows, np.float32)])
    perm = rng.permutation(len(boxes))
    return boxes[perm], np.concatenate([valid, np.ones(24, bool)])[perm]


@pytest.mark.parametrize("case,thr", [
    ("chain_reversed", 0.9), ("all_invalid", 0.9), ("one_row", 0.9),
    ("n_77", 0.9), ("iou_exactly_thr", 0.9), ("iou_exactly_thr", 0.95)])
def test_self_cluster_hard_cases_match_jax(case, thr):
    """The closure's hard cases against JAX's ``self_cluster_index``, through
    the port's plain version and through a numpy model of K11's union-find
    (``_union_find_model``): a chain of 128 boxes whose lowest index is
    reached in up to 127 hops, in reversed order; every row invalid; one
    row (n = 1 on the port's side, held against the first row of JAX's
    answer with 76 invalid rows after it, which join nothing); n = 77, no
    multiple of 32 or 64; pairs at IoU exactly f32(thr), which join, beside
    pairs an ulp of width below, which do not. JAX runs op by op: its
    compiled function put one of the rows of the exact pairs in another
    cluster."""
    rng = np.random.RandomState(77)
    boxes, valid = _hard_case(case, thr, rng)
    jkeep, jrep = map(np.asarray, jdedup.self_cluster_index(
        jnp.asarray(boxes), jnp.asarray(valid), thr))
    keep, rep = tdedup.self_cluster_index(torch.from_numpy(boxes),
                                          torch.from_numpy(valid), thr)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(rep.numpy(), jrep)
    if case == "one_row":
        keep, rep = tdedup.self_cluster_index(torch.from_numpy(boxes[:1]),
                                              torch.from_numpy(valid[:1]), thr)
        np.testing.assert_array_equal(keep.numpy(), jkeep[:1])
        np.testing.assert_array_equal(rep.numpy(), jrep[:1])
        assert jkeep[0] and jrep[0] == 0
    mkeep, mrep = _union_find_model(boxes, valid, thr, rng)
    np.testing.assert_array_equal(mkeep, jkeep)
    np.testing.assert_array_equal(mrep, jrep)
    iou = np.asarray(pairwise_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    if case == "chain_reversed":
        assert (jrep == 0).all() and iou[0, 127] < thr
    elif case in ("all_invalid", "one_row"):
        assert np.array_equal(jrep, np.arange(len(boxes)))
        assert np.array_equal(jkeep, valid)
    elif case == "iou_exactly_thr":
        exact = np.argwhere(iou == np.float32(thr))
        near = np.argwhere((iou < np.float32(thr)) & (iou > thr - 1e-6))
        assert len(exact) and len(near)
        assert all(jrep[i] == jrep[j] for i, j in exact)
        assert all(jrep[i] != jrep[j] for i, j in near)


def test_self_cluster_mask_matches_jax():
    rng = np.random.RandomState(4)
    boxes, valid = clustered_boxes(rng, 80)
    jd, td = _dets(boxes, valid, rng)
    np.testing.assert_array_equal(
        tdedup.self_cluster_mask(td, 0.9).numpy(),
        np.asarray(jdedup.self_cluster_mask(jd, 0.9)))


def test_duplicate_mask_and_delete_match_jax():
    rng = np.random.RandomState(5)
    boxes, valid = clustered_boxes(rng, 64)
    jd, td = _dets(boxes, valid, rng)
    got = tdedup.duplicate_mask(td.boxes, td.valid).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jdedup.duplicate_mask(jd.boxes, jd.valid)))
    assert got.any()
    np.testing.assert_array_equal(
        tdedup.delete_duplicate_boxes(td).valid.numpy(),
        np.asarray(jdedup.delete_duplicate_boxes(jd).valid))


def test_online_boxes_merging_matches_jax():
    rng = np.random.RandomState(6)
    boxes, valid = clustered_boxes(rng, 48)
    boxes[1::3] = boxes[::3][:len(boxes[1::3])] + rng.uniform(
        -0.9, 0.9, (len(boxes[1::3]), 4)).astype(np.float32)
    jd, td = _dets(boxes, valid, rng)
    idx = rng.randint(0, 6, len(boxes)).astype(np.int32)
    got = tdedup.online_boxes_merging(td, td, torch.from_numpy(idx)).numpy()
    want = np.asarray(jdedup.online_boxes_merging(jd, jd, jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)
    assert (got != valid).any()


class _TorchPoolModel:
    """The stand-in of tests/test_shared_pool.py: features of the box."""

    def pool_boxes(self, feats, boxes, resolution):
        return torch.cat([boxes, boxes * 2.0], dim=-1)


@pytest.mark.parametrize("budget", [96, 40, 8])
def test_shared_pool_matches_jax(budget):
    """Budgets above, near and below the cluster count: the stable order,
    the members' representatives and the clamp of their positions to
    ``budget - 1``."""
    rng = np.random.RandomState(budget)
    boxes, valid = zip(*[clustered_boxes(rng, 96) for _ in range(2)])
    boxes, valid = np.stack(boxes), np.stack(valid)
    jcfg = jpipe.PipelineConfig(num_classes=2, share_crops_budget=budget)
    tcfg = tpipe.PipelineConfig(num_classes=2, share_crops_budget=budget)
    want = np.asarray(jpipe.shared_pool(_PoolModel(), None, None,
                                        jnp.asarray(boxes),
                                        jnp.asarray(valid), jcfg))
    got = tpipe.shared_pool(_TorchPoolModel(), None,
                            torch.from_numpy(boxes),
                            torch.from_numpy(valid), tcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tcfg.share_crops_thresh == jcfg.share_crops_thresh
