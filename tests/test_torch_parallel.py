"""The port's data parallelism (``coin_tpu_torch/parallel/``) on the CPU,
over gloo.

- Without a process group the port's ``multihost`` gives what the JAX
  package's gives in one process.
- One two-rank launch (``tests/torch_dp_worker.py``, two processes that
  import no JAX, a ``FileStore`` in ``tmp_path``, a timeout of its own)
  holds, on a global batch of 2 images split 1 + 1:
  ``all_gather_objects``; ``merge_result_stores`` chunked and whole
  (against the JAX ``ResultStore.merge`` of the same shards, array for
  array); one cached adaptation step in f32 and one with the int8 res5 at
  one scale per tensor, one pre-train step and one oracle step, each
  against the port's single-process step on the same 2 images from the
  same state (the losses, every updated tensor's update over its largest
  entry beyond the f32 rounding of its parameters, the CKG net's update,
  the prototypes), and the global int8 scale at 1e-6 of the
  single-process abs-max's; the sharded collection of the synthetic
  teacher and the trainer's sharded teacher refresh, equal to the
  single-process stores; the evaluation over batches sharded by rank.

Tolerances. A rank's backbone on 1 image and the single process's on 2
differ in the last bits (oneDNN's convolutions block by batch: 7.5e-7 of
the features' largest entry, 4.2e-7 without oneDNN), so nothing here is
bit for bit. f32: losses and prototypes to tests/test_torch_train_step.py's
REL (measured 3.0e-7 and 3.1e-8), the CKG to its REL_MERGE (measured
1.1e-7), the updates to DP_REL = 5e-4 (measured 1.28e-4 adaptation,
1.49e-4 oracle, 9.2e-7 pre-train, every time in res5's first 1 x 1 conv,
whose weight gradient sums the crops of the images in another order; the
same step at 1 and 3 threads differs by 1.5e-6). int8: against the plain
single-process step the losses and prototypes to INT8_REL (measured
7.8e-5 and 2.0e-7), while the updates differ by 4.1e-2 (the box
predictor's trans_0 bias): the backbone's last bits move s8 values of
res5's input across a rounding step. The witness is the single-process
step with its backbone run rank by rank, 1 image a call, and nothing else
changed: it is as far from the plain step (4.1e-2, the same bias), and
the data-parallel step matches it at the f32 bounds (measured: updates
3.9e-7, losses 3.3e-8, the CKG 0).
- The evaluation over batches sharded by rank: the single-process AP and
  detection pickle.
- ``TrainLoader(rank=, world=)``: the shards put back together are the
  JAX ``TrainLoader``'s global batches.
- The given-scale quantisation's plain version, handed a tensor's own
  abs-max, is ``quantize_plain``; a world that does not divide the batch
  raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import coin_tpu.native
import coin_tpu_torch.native
from coin_tpu.engine.results_store import ResultStore as JStore
from coin_tpu.parallel import multihost as jmultihost
from coin_tpu_torch.parallel import mesh_utils, multihost
from tests import torch_dp_worker as worker
from tests.test_torch_models import two_torch_threads  # noqa: F401
from tests.test_torch_train_step import INT8_REL, REL, REL_MERGE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 240
DP_REL = 5e-4


def test_single_process_helpers_match_jax():
    """One process, no group: the same counts, rank and gathers as the JAX
    package's multihost, and the store returned as it is."""
    assert multihost.process_count() == jmultihost.process_count() == 1
    assert multihost.process_index() == jmultihost.process_index() == 0
    assert multihost.is_main_process() and jmultihost.is_main_process()
    obj = {"a": np.arange(3)}
    got, want = (m.all_gather_objects(obj) for m in (multihost, jmultihost))
    assert len(got) == len(want) == 1 and got[0] is obj
    store = object.__new__(JStore)
    assert multihost.merge_result_stores(store) is store
    assert mesh_utils.train_group() is None
    with mesh_utils.data_parallel(None):
        x = torch.arange(4.0)
        assert mesh_utils.global_sum(x)[0] is x
        assert mesh_utils.global_batch(3) == 3
        assert mesh_utils.differentiable_sum(x) is x


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """Two ranks of tests/torch_dp_worker.py over gloo; rank 0's report."""
    root = tmp_path_factory.mktemp("dp")
    npz = worker.make_data(str(root))
    spec = {"root": str(root), "npz": npz, "out": str(root / "out"),
            "init": str(root / "filestore"),
            "union_npz": str(root / "union.npz"),
            "result": str(root / "result.json")}
    with open(root / "spec.json", "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dp_worker", str(r), "2",
         str(root / "spec.json")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    with open(spec["result"]) as f:
        res = json.load(f)
    res["spec"] = spec
    return res


def test_launch_gathers_objects(launch):
    assert launch["gather"] and launch["world_size"] == launch["world"] == 2
    # each rank's loader holds the global batch; its batches, a shard
    assert launch["loader_batch"] == worker.BATCH


@pytest.mark.parametrize("how", ["chunked", "whole"])
def test_merge_result_stores_matches_jax_merge(launch, how):
    """The union of two shards over two ranks (chunked: one image id per
    chunk) holds every image's arrays of the whole store, and equals the
    JAX ResultStore.merge of the same shards array for array."""
    assert launch["union"][how]
    full = JStore.load(launch["spec"]["npz"])
    ids = sorted(full.image_ids())
    merged = JStore(full.num_classes)
    for r in range(2):
        shard = JStore(full.num_classes)
        shard._data = {i: full._data[i] for i in ids[r::2]}
        merged.merge(shard)
    got = JStore.load(launch["spec"]["union_npz"])
    assert sorted(got.image_ids()) == sorted(merged.image_ids())
    for i in ids:
        assert sorted(got._data[i]) == sorted(merged._data[i])
        for k, v in merged._data[i].items():
            np.testing.assert_array_equal(got._data[i][k], v)


def _held(r, rel, update_rel, rel_merge=None, merge=True, protos=True):
    assert r["moved"], "the single-process step moved no parameter"
    assert r["losses"] <= rel, r
    assert r["update"] <= update_rel, r
    if merge:
        assert r["merge_moved"], "train_merge: the CKG net did not move"
        assert r["merge_update"] <= rel_merge, r
    if protos:
        assert r["proto_moved"] and r["prototypes"] <= rel, r


def test_data_parallel_adaptation_step_f32(launch):
    """One cached adaptation step on 2 x 1 images against the
    single-process step on 2: losses, updates, the CKG net (its
    second-order merge gradient summed over the ranks) and the
    prototypes."""
    _held(launch["adapt_f32"], REL, DP_REL, REL_MERGE)


def test_data_parallel_adaptation_step_int8(launch):
    """The same with the int8 res5 at one scale per tensor: the given-scale
    mode ran, and its scale (the all-reduced abs-max) is the
    single-process abs-max's. Against the single-process step whose
    backbone runs rank by rank (``backbone_by_rank``) the step is held to
    the f32 bounds; against the plain single-process step its losses and
    prototypes to INT8_REL, and its updates are as far from that step as
    the rank-by-rank step's are (the witness: the whole gap is the
    backbone's rounding over 1 image against 2, which res5's s8 rounding
    makes whole quantisation steps)."""
    r = launch["adapt_int8"]
    assert r["given_launched"]
    assert r["scale"] <= 1e-6, r
    _held(r["vs_split"], REL, DP_REL, REL_MERGE)
    assert r["losses"] <= INT8_REL and r["prototypes"] <= INT8_REL, r
    assert abs(r["update"] - r["witness"]["update"]) <= DP_REL, r


def test_sharded_evaluation_is_the_single_process_evaluation(launch):
    """Evaluation over batches sharded by rank (batch j on rank j mod 2,
    the last one padded) gives the single-process AP, and rank 0's
    detection pickle is the single-process pickle byte for byte (the
    same rows in the same order)."""
    e = launch["eval"]
    assert e["detections"] > 0 and e["ap"] and e["pickle"], e


def test_data_parallel_pretrain_step(launch):
    _held(launch["pretrain"], REL, DP_REL, merge=False)


def test_data_parallel_oracle_step(launch):
    _held(launch["oracle"], REL, DP_REL, merge=False, protos=False)


@pytest.mark.parametrize("which", ["collect", "refresh"])
def test_sharded_collection_is_the_single_process_store(launch, which):
    """Stage 1 with the synthetic teacher (one image a batch, 4 batches a
    rank) and the trainer's teacher refresh (two batches of 4, one a
    rank, int8 collection): the union on the ranks is the single-process
    store, array for array."""
    assert launch["images"] == 8
    assert launch[which]


@pytest.fixture
def pil_decode(monkeypatch):
    monkeypatch.setattr(coin_tpu.native, "available", lambda: False)
    monkeypatch.setattr(coin_tpu_torch.native, "available", lambda: False)


def test_train_loader_shards_match_jax(tmp_path, pil_decode):
    """Rank 0's and rank 1's batches of TrainLoader(rank, world=2), put back
    together, are the JAX TrainLoader's global batches of the same seed."""
    from coin_tpu.data import voc as jvoc
    from coin_tpu.data.loader import TrainLoader as JTrainLoader
    from coin_tpu_torch.data import voc as tvoc
    from coin_tpu_torch.data.loader import TrainLoader
    jvoc.make_synthetic_voc(str(tmp_path / "synth/VOC2007"), num_images=6,
                            split="train")
    for reg in (jvoc.register_pascal_voc, tvoc.register_pascal_voc):
        reg("dpshardtrain", "synth/VOC2007", "train", worker.CLASSES, ".jpg")
    kw = dict(batch_size=4, seed=5, min_size=64, max_size=96)
    want = JTrainLoader("dpshardtrain", str(tmp_path), **kw)._gen()
    shards = [TrainLoader("dpshardtrain", str(tmp_path), rank=r, world=2,
                          **kw)._gen() for r in range(2)]
    for _ in range(3):
        w = next(want)
        parts = [next(s) for s in shards]
        for field in ("images", "image_hw", "flip", "indices", "gt_boxes",
                      "gt_classes", "gt_valid"):
            np.testing.assert_array_equal(
                np.concatenate([getattr(p, field) for p in parts]),
                getattr(w, field), err_msg=field)
        assert sum((p.image_ids for p in parts), []) == list(w.image_ids)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_given_scale_plain_is_quantize_plain_at_its_own_absmax(dtype):
    from coin_tpu_torch.ops import qconv
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((3, 5, 7, 8), generator=g) * 3).to(dtype)
    x[0, 0, 0, :3] = 0.0
    amax = qconv.absmax_plain(x)
    assert amax.shape == (1,) and amax.dtype == torch.float32
    q, s = qconv.quantize_given_plain(x, amax)
    wq, ws = qconv.quantize_plain(x)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    x[1, 2, 3, 4] = float("nan")
    q, s = qconv.quantize_given_plain(x, qconv.absmax_plain(x))
    wq, ws = qconv.quantize_plain(x)
    assert torch.equal(q, wq) and s.isnan().all() and ws.isnan().all()


def test_world_that_does_not_divide_the_batch_raises(tmp_path):
    """Every rank must hold a shard: 2 ranks and the shipped batch of 3
    raise, naming the JAX mesh's choice (1 device), as do 4 ranks and a
    batch of 6 (3 devices); the loader refuses such a world too."""
    with pytest.raises(ValueError, match="on 1 devices"):
        mesh_utils.check_batch(3, 2)
    with pytest.raises(ValueError, match="on 3 devices"):
        mesh_utils.check_batch(6, 4)
    mesh_utils.check_batch(4, 2)
    mesh_utils.check_batch(3, 1)
    from coin_tpu_torch.data.loader import TrainLoader
    with pytest.raises(ValueError, match="does not divide"):
        TrainLoader("dpsynthtrain", str(tmp_path), batch_size=3, rank=0,
                    world=2)
