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

from chip_smoke import clustered_boxes
from coin_tpu.engine import pipelines as jpipe
from coin_tpu.ops import dedup as jdedup
from coin_tpu.ops.boxes import pairwise_iou
from coin_tpu.structures import Detections as JDetections
from coin_tpu_torch.engine import pipelines as tpipe
from coin_tpu_torch.ops import dedup as tdedup
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
