"""The port's A/B harness, ``coin_tpu_torch.tools.validate``, against the
JAX harness ``tools/validate_cached_teacher.py`` (loaded by file path) and
the JAX package on the CPU:

- ``make_synthetic_voc_rich`` writes the same JPEG bytes, XML and split
  file for a few images of both splits' seeds;
- ``synth_store`` builds the same store, every array;
- every mode (and a ``--multi`` sweep) hands ``pretrain`` and ``run_one``
  the same configs and arguments as the JAX harness: both are replaced by
  recorders, and each ``main`` runs 1 seed over 2 + 2 images;
- the port's aggregate, fed the record's ``per_seed`` rows, reproduces
  ``bench_artifacts/ab_shipped_i8_v3_s16.json``'s aggregate;
- one end-to-end CPU run of the tool (``--device cpu``, the ``aa`` mode, a
  few images and iterations at reduced widths) writes an artifact that
  ``tools/ab_aggregate.py`` reads.

Every dataset and checkpoint is written under pytest's tmp_path (the
harnesses' ``tempfile`` roots point there) and deleted after.
"""

import importlib.util
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import pytest
import torch

from coin_tpu.data import voc as jvoc
from coin_tpu_torch.data import voc as tvoc
from coin_tpu_torch.tools import validate as tval
from tests.test_torch_models import two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO, "bench_artifacts", "ab_shipped_i8_v3_s16.json")


def _load_by_path(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jval():
    return _load_by_path("validate_cached_teacher",
                         "tools/validate_cached_teacher.py")


@pytest.fixture
def scratch(tmp_path, monkeypatch):
    """A directory for the harnesses' ``tempfile`` roots, removed after."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("split,seed", [("train", 0), ("val", 7)])
def test_synthetic_voc_rich_writes_the_same_bytes(scratch, split, seed):
    roots = [str(scratch / side) for side in ("jax", "port")]
    jvoc.make_synthetic_voc_rich(roots[0], num_images=4, seed=seed,
                                 split=split)
    tvoc.make_synthetic_voc_rich(roots[1], num_images=4, seed=seed,
                                 split=split)
    want, got = _files(roots[0]), _files(roots[1])
    assert len(got) == 4 * 2 + 1 and sorted(got) == sorted(want)
    assert all(got[k] == want[k] for k in want)


def test_synth_store_equals_the_jax_harness_store(scratch, jval):
    root = str(scratch / "voc")
    tvoc.make_synthetic_voc_rich(root, num_images=6, split="train")
    records = tvoc.load_voc_instances(root, "train", ("car", "person"),
                                      ".jpg")
    want, got = jval.synth_store(records, 2), tval.synth_store(records, 2)
    assert sorted(got._data) == sorted(want._data)
    for image_id, rec in want._data.items():
        assert sorted(got._data[image_id]) == sorted(rec)
        for k, v in rec.items():
            assert got._data[image_id][k].dtype == v.dtype, k
            np.testing.assert_array_equal(got._data[image_id][k], v)


def _as_dict(cfg):
    """A config as plain dicts, without its per-run directories."""
    out = json.loads(json.dumps(cfg))
    out.pop("OUTPUT_DIR")
    out["DATASETS"].pop("ROOT")
    return out


def _record(mod, calls):
    def pretrain(cfg, store, iters, *device):
        calls.append(("pretrain", _as_dict(cfg), iters))
        return os.path.join(cfg.OUTPUT_DIR, "ckpt"), 50.0

    def run_one(cfg, store, cache, weights="", perturb=False, **device):
        calls.append(("run_one", _as_dict(cfg), bool(cache),
                      os.path.basename(weights), bool(perturb)))
        return {"9": 40.0, "19": 41.0}, 1.0
    return pretrain, run_one


@pytest.mark.parametrize("mode", tval.MODES + ("multi",))
def test_every_mode_sets_the_jax_harness_knobs(scratch, jval, monkeypatch,
                                               mode):
    import coin_tpu.utils.setup as jsetup
    monkeypatch.setattr(jsetup, "enable_compile_cache", lambda: None)
    argv = ["--seeds", "1", "--images", "2", "--eval-images", "2",
            "--iters", "20", "--pre-iters", "5", "--eval-every", "10"]
    argv += (["--multi", "int8train_ps:0-0,aa:0-0"] if mode == "multi"
             else ["--mode", mode])
    calls = {}
    for side, mod, extra in (("jax", jval, []),
                             ("port", tval, ["--device", "cpu"])):
        calls[side] = []
        pre, run = _record(mod, calls[side])
        monkeypatch.setattr(mod, "pretrain", pre)
        monkeypatch.setattr(mod, "run_one", run)
        mod.main(argv + ["--out", str(scratch / side / "ab.json")] + extra)
    assert calls["port"] == calls["jax"]
    assert [c[0] for c in calls["port"]] == (
        ["pretrain", "run_one", "run_one"]
        + (["run_one"] if mode == "multi" else []))
    arts = {}
    for side in ("jax", "port"):
        name = "ab_aa_v3_s1.json" if mode == "multi" else "ab.json"
        with open(scratch / side / name) as f:
            arts[side] = json.load(f)
    keys = ("mode", "arms", "per_seed", "delta_avg3_mean", "verdict")
    assert {k: arts["port"][k] for k in keys} == \
        {k: arts["jax"][k] for k in keys}


def test_aggregate_reproduces_the_record():
    with open(RECORD) as f:
        rec = json.load(f)
    args = tval.parse_args(["--mode", rec["mode"], "--seeds",
                            str(rec["seeds"]), "--device", "cpu"])
    got = tval.aggregate(rec["mode"], args, rec["arms"], rec["per_seed"])
    for k in ("delta_avg3_mean", "delta_avg3_sd", "delta_mean", "delta_sd",
              "final_base_mean", "final_var_mean"):
        assert got[k] == pytest.approx(rec[k], rel=1e-12), k
    for k in ("delta_avg3_ci95", "delta_ci95"):
        np.testing.assert_allclose(got[k], rec[k], rtol=1e-12)
    for k in ("verdict", "n_functional", "primary_endpoint", "n_avg3",
              "n_positive_primary", "n_negative_primary", "exclusion_rule",
              "iters", "pretrain_iters", "images", "eval_images"):
        assert got[k] == rec[k], k


def test_end_to_end_cpu_run_writes_what_ab_aggregate_reads(scratch,
                                                           monkeypatch,
                                                           capsys):
    """``main`` of the ``aa`` mode on the CPU: a 1-step pre-train, then
    both arms (the variant's weights perturbed) for 1 step and an eval,
    at tiny widths (64 x 96 canvas, a 1-layer 32-wide text tower, RPN
    top-k 64 / 8, 8 RoIs an image)."""
    build = tval.build_cfg

    def tiny(*a, **k):
        cfg = build(*a, **k)
        cfg.INPUT.MIN_SIZE_TRAIN = cfg.INPUT.MIN_SIZE_TEST = 64
        cfg.INPUT.MAX_SIZE = 96
        for s in ("TRAIN", "TEST"):
            cfg.MODEL.RPN[f"PRE_NMS_TOPK_{s}"] = 64
            cfg.MODEL.RPN[f"POST_NMS_TOPK_{s}"] = 8
        cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 8
        cfg.TPU.TEXT_LAYERS, cfg.TPU.TEXT_WIDTH = 1, 32
        return cfg
    monkeypatch.setattr(tval, "build_cfg", tiny)
    perturbed = []
    perturb = tval.perturb_state

    def spy(state, seed):
        before = state.model.backbone.conv1.weight.clone()
        perturb(state, seed)
        after = state.model.backbone.conv1.weight
        perturbed.append((seed, float((after / before - 1).abs().max())))
        assert torch.equal(state.teacher.backbone.conv1.weight, after)
    monkeypatch.setattr(tval, "perturb_state", spy)
    out = scratch / "art" / "ab_aa.json"
    tval.main(["--mode", "aa", "--seeds", "1", "--images", "2",
               "--eval-images", "2", "--pre-iters", "1", "--iters", "1",
               "--eval-every", "1", "--device", "cpu", "--out", str(out)])
    assert perturbed and perturbed[0][0] == 2024 + 777
    assert 0 < perturbed[0][1] < 1e-5
    with open(out) as f:
        art = json.load(f)
    row = art["per_seed"][0]
    assert art["platform"] == "cpu" and art["arms"] == ["aa_base",
                                                        "aa_perturbed"]
    assert set(row["aa_base_ap50"]) == set(row["aa_perturbed_ap50"]) == {"0"}
    assert all(0.0 <= v <= 100.0 for v in row["aa_base_ap50"].values())
    assert os.path.exists(str(out) + ".partial")
    # the run's data and checkpoint directories are gone
    assert not [d for d in os.listdir(scratch) if d.startswith("ab_")]
    capsys.readouterr()
    ab = _load_by_path("ab_aggregate", "tools/ab_aggregate.py")
    monkeypatch.setattr(sys, "argv", ["ab_aggregate.py",
                                      str(out) + ".partial"])
    ab.main()
    report = json.loads(capsys.readouterr().out)
    assert report["mode"] == "aa"
    assert report["excluded_seeds"] == ([0] if row["excluded"] else [])


def test_welch_test_matches_scipy(rng):
    """``tools.ab_compare.welch`` (its own incomplete beta function)
    against scipy's Welch test, and the record against itself."""
    from scipy import stats
    from coin_tpu_torch.tools import ab_compare
    for na, nb, shift in ((4, 16, 0.0), (4, 16, 3.0), (3, 5, 10.0),
                          (16, 16, 0.5)):
        a = rng.randn(na) * 3.0 + 35.0 + shift
        b = rng.randn(nb) * 2.0 + 35.0
        want = stats.ttest_ind(a, b, equal_var=False)
        got = ab_compare.welch(a, b)
        assert got["t"] == pytest.approx(want.statistic, rel=1e-12)
        assert got["p"] == pytest.approx(want.pvalue, rel=1e-9, abs=1e-14)
    with open(RECORD) as f:
        rec = json.load(f)
    out = ab_compare.compare(rec, rec)
    assert out["all_match"] and all(
        e["p"] == pytest.approx(1.0) for e in out["endpoints"].values())
    assert out["verdict"] == "PASS"
