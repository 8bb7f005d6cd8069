"""The port's adaptation trainer (coin_tpu_torch.engine.trainer.CoinTrainer)
against the JAX package's on the CPU, with foggy_fast.yaml's int8 knobs
(TPU.INT8_TRAIN: int8 res5 training, TPU.INT8_COLLECT: int8 collection) on
the synthetic setup of tests/test_adaptation_e2e.py.

Tolerances. The loader, the store and the loop's control flow are exact.
Detections are compared against the JAX package's compiled inference:
under ``jit`` XLA computes the int8 scales with a reciprocal product where
the port divides (tests/test_torch_qconv.py), and f32 convolutions sum in
another order, so a few activations round to the neighbouring s8 value
(the fault test prints that share at res5's input and bounds it by 1e-3).
With int8 in res5 only (the fault test) every detection has a partner of
its class on the other side (near-tied scores may order them
differently), and boxes (in pixels), scores and probabilities agree to
1e-3 (measured: 3.5e-4 and 1e-4; with a plain res5 in place of the int8
one, detections lack a partner). The collection pass is held with res5 in
f32 on both sides (see its test for why). With
every conv in int8 (INT8_COLLECT) each flipped s8 value moves a whole
quantisation step and about fifty convs compound the flips: the compiled
JAX backbone lands 2.5 % away from its own source run op by op, so the
int8 backbone is held bit for bit to JAX run op by op instead.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coin_tpu.native
from coin_tpu.config import load_config as jload_config
from coin_tpu.data import voc as jvoc
from coin_tpu.data.loader import TrainLoader as JTrainLoader
from coin_tpu.engine import pipelines as jpipe
from coin_tpu.engine.results_store import ResultStore as JStore
from coin_tpu.engine.trainer import CoinTrainer as JTrainer
from coin_tpu_torch.config import load_config
from coin_tpu_torch.convert_from_jax import load_train_state
from coin_tpu_torch.data import voc as tvoc
from coin_tpu_torch.data.augment import normalize_batch
from coin_tpu_torch.data.loader import TrainLoader
from coin_tpu_torch.engine import pipelines as tpipe
from coin_tpu_torch.engine.results_store import ResultStore
from coin_tpu_torch.engine.trainer import CoinTrainer
from tests.test_adaptation_e2e import synth_store
from tests.test_torch_inference import _inputs, _tcfg
from tests.test_torch_models import tiny_pair
from tests.test_torch_models import two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("car", "person")
TOL = 1e-3


def _settings(cfg, root, out):
    """tests/test_adaptation_e2e.py:53-82, with foggy_fast.yaml's int8
    knobs, the cache from step 0 and a refresh every epoch."""
    cfg.DATASETS.ROOT = str(root)
    cfg.DATASETS.TRAIN_UNLABEL = ["tsynthtrain"]
    cfg.DATASETS.TEST = ["tsynthval"]
    cfg.OUTPUT_DIR = str(out)
    cfg.SOLVER.IMG_PER_BATCH_UNLABEL = 2
    cfg.SOLVER.MAX_ITER = 4
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.STEPS = [100]
    cfg.SOLVER.FACTOR_LIST = [1, 0.1]
    cfg.SOLVER.CHECKPOINT_PERIOD = 1000
    cfg.TEST.EVAL_PERIOD = 1000
    cfg.TEST.DETECTIONS_PER_IMAGE = 8
    cfg.INPUT.MIN_SIZE_TRAIN = 64
    cfg.INPUT.MIN_SIZE_TEST = 64
    cfg.INPUT.MAX_SIZE = 96
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 16
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 16
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 16
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.MODEL.MERGE_DIM = 1024
    cfg.TPU.TEXT_LAYERS = 1
    cfg.TPU.TEXT_WIDTH = 32
    cfg.TPU.TEXT_HEADS = 2
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.CAP_TEACHER = 8
    cfg.TPU.TEACHER_PRE_NMS_TOPK = 32
    cfg.TPU.TEACHER_POST_NMS_TOPK = 4
    cfg.TPU.CAP_C = 8
    cfg.TPU.INT8_TRAIN = True
    cfg.TPU.INT8_COLLECT = True
    cfg.TPU.CACHE_TEACHER_MIN_STEPS = 0
    cfg.TPU.TEACHER_REFRESH_EPOCHS = 1
    cfg.CLOUD.BURN_UP_STEP = 2
    cfg.CLOUD.PROTOTYPE_UPDATE_START = 1
    cfg.CLOUD.CLASSES_WEIGHT = [1.0, 1.0, 0.9]
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    jvoc.make_synthetic_voc(str(root / "synth/VOC2007"), num_images=4,
                            split="train")
    jvoc.make_synthetic_voc(str(root / "synth/VOC2007"), num_images=4,
                            split="val", seed=7)
    for reg in (jvoc.register_pascal_voc, tvoc.register_pascal_voc):
        reg("tsynthtrain", "synth/VOC2007", "train", CLASSES, ".jpg")
        reg("tsynthval", "synth/VOC2007", "val", CLASSES, ".jpg")
    records = jvoc.load_voc_instances(str(root / "synth/VOC2007"), "train",
                                      CLASSES, ".jpg")
    jstore = synth_store(records, num_classes=len(CLASSES))
    npz = str(root / "collect.npz")
    jstore.save(npz)
    out = tmp_path_factory.mktemp("out")
    return dict(root=root, out=out, jstore=jstore, npz=npz,
                jcfg=_settings(jload_config(), root, out),
                cfg=_settings(load_config(), root, out))


@pytest.fixture
def pil_decode(monkeypatch):
    """The JAX loaders decode with PIL, as the port does (the native
    libjpeg decoder is ROADMAP 8b)."""
    monkeypatch.setattr(coin_tpu.native, "available", lambda: False)


def _port_trainer(setup, **overrides):
    cfg = setup["cfg"].clone()
    for k, v in overrides.items():
        node, _, leaf = k.rpartition(".")
        (cfg.get_path(node) if node else cfg)[leaf] = v
    return CoinTrainer(cfg, store=ResultStore.load(setup["npz"]),
                       device="cpu")


# ------------------------------------------------------------- the fault
def test_int8_train_detector_inference_matches_jax():
    """The repair: with TPU.INT8_TRAIN (foggy_fast.yaml) build_detector
    gives the JAX package's int8-res5 detector (quant_train_res5 = 1), so
    its inference matches JAX's on the same converted weights. (Before, the
    port built a plain res5, whose detections differ at the int8
    quantisation's ~1 % scale and lose their partners.)"""
    jmodel, pcfg, tokens, variables, _ = tiny_pair()
    cfg = load_config(os.path.join(REPO,
                                   "configs/coin/GDINO/foggy_fast.yaml"))
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.TEXT_LAYERS, cfg.TPU.TEXT_WIDTH, cfg.TPU.TEXT_HEADS = 2, 64, 2
    assert tpipe.int8_train_mode(cfg) == 1
    from coin_tpu_torch.convert_from_jax import from_jax_variables
    model = tpipe.build_detector(cfg, pcfg.num_classes, "cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    assert model.quant_train_res5 == 1 and not model.quant_convs

    images_u8, hw = _inputs()
    jm = jmodel.clone(quant_train_res5=1)
    want = jax.jit(lambda v, x, h, t: jpipe.inference(
        jm, v, x, h, t, pcfg))(variables, _jnorm(images_u8),
                               jnp.asarray(hw), tokens)
    with torch.no_grad():
        got = tpipe.inference(model, normalize_batch(
            torch.from_numpy(images_u8)), torch.from_numpy(hw),
            torch.from_numpy(np.asarray(tokens)).long(), _tcfg(pcfg))
    for i in range(len(images_u8)):
        _check_view(_image_view(got, i), _image_view(want, i), f"image {i}")

    # the share of res5's first s8 activations that round differently in
    # JAX's compiled quantiser and the port's, on the same crops
    from coin_tpu.ops.qconv import _quantize_x
    from coin_tpu_torch.ops.qconv import quantize_plain
    from coin_tpu_torch.ops.roi_align import roi_align_batched
    with torch.no_grad():
        feats = model.features(normalize_batch(torch.from_numpy(images_u8)))
        crops = roi_align_batched(feats, got.boxes, 1 / 16, 14, 2)
    crops = crops.flatten(0, 1)
    jq, _ = jax.jit(_quantize_x)(jnp.asarray(crops.numpy()))
    share = float((np.asarray(jq) != quantize_plain(crops)[0].numpy())
                  .mean())
    print(f"s8 values of res5's input that differ: {share:.3g}")
    assert share <= 1e-3


def _image_view(dets, i):
    """The valid detections of image ``i`` as a store view."""
    v = np.asarray(dets.valid[i])
    return {k: np.asarray(getattr(dets, k)[i])[v]
            for k in ("boxes", "classes", "scores", "probs")}


def _check_view(got, want, what):
    """Every detection of ``want`` (JAX) pairs with one of ``got`` (the
    port) of its class whose box, score and probabilities agree to TOL."""
    assert len(want["boxes"]) > 0, what
    assert len(got["boxes"]) == len(want["boxes"]), what
    free = list(range(len(got["boxes"])))
    for i in range(len(want["boxes"])):
        near = [j for j in free if got["classes"][j] == want["classes"][i]
                and all(np.abs(got[k][j] - want[k][i]).max() <= TOL
                        for k in ("boxes", "scores", "probs"))]
        assert near, f"{what}: JAX detection {i} has no partner"
        free.remove(near[0])


def _jnorm(images_u8):
    from coin_tpu.data.augment import normalize_batch as jn
    return jn(jnp.asarray(images_u8))


# ------------------------------------------------------- loader and store
def test_train_loader_batches_match_jax(setup, pil_decode):
    """One seed, one order: indices, flips, canvas sizes, scales, images
    and the packed cloud views of the first batches are the JAX loader's."""
    kw = dict(batch_size=2, seed=11, min_size=64, max_size=96,
              store_cap=8)
    jl = JTrainLoader("tsynthtrain", str(setup["root"]),
                      store=setup["jstore"], **kw)
    tl = TrainLoader("tsynthtrain", str(setup["root"]),
                     store=ResultStore.load(setup["npz"]), **kw)
    assert tuple(tl.canvas_hw) == tuple(jl.canvas_hw)
    for jb, tb in zip([b for _, b in zip(range(5), iter(jl))],
                      [b for _, b in zip(range(5), iter(tl))]):
        assert tb.image_ids == jb.image_ids
        for f in ("indices", "flip", "image_hw", "orig_hw", "scale",
                  "images", "gt_boxes", "gt_classes", "gt_valid"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f),
                                          err_msg=f)
        for view in ("RCNN", "RPN"):
            for k, v in jb.online[view].items():
                np.testing.assert_array_equal(tb.online[view][k], v,
                                              err_msg=f"{view}/{k}")


def test_result_store_npz_round_trip(setup, tmp_path):
    """The port's store reads the JAX package's npz and writes one that
    both packages read back unchanged."""
    store = ResultStore.load(setup["npz"])
    jstore = setup["jstore"]
    assert sorted(store.image_ids()) == sorted(jstore.image_ids())
    path = str(tmp_path / "port.npz")
    store.save(path)
    for back in (ResultStore.load(path), JStore.load(path)):
        for image_id in jstore.image_ids():
            for view in ("RCNN", "RPN"):
                a = jstore.pack_view(image_id, view, 8, 0.75, True, 90.0)
                b = back.pack_view(image_id, view, 8, 0.75, True, 90.0)
                for k in a:
                    np.testing.assert_array_equal(b[k], a[k])


# ----------------------------------------------------------- the trainer
@pytest.fixture(scope="module")
def jax_trainer(setup):
    return JTrainer(setup["jcfg"].clone(), store=setup["jstore"])


def _state_from_jax(trainer, jtr):
    load_train_state(trainer.state, jax.device_get(
        dataclasses.replace(jtr.state, rng=None)))
    return trainer


def _collect_two_images(trainers, setup, monkeypatch):
    """Point each trainer's collection pass at the first two train images,
    in one batch."""
    from coin_tpu.data.loader import TestLoader as JTestLoader
    from coin_tpu_torch.data.loader import TestLoader
    for t in trainers:
        cls = TestLoader if isinstance(t, CoinTrainer) else JTestLoader
        loader = cls("tsynthtrain", str(setup["root"]), batch_size=2,
                     min_size=64, max_size=96,
                     canvas_hw=t.train_loader.canvas_hw)
        loader.records = loader.records[:2]
        monkeypatch.setattr(t, "_collect_loader", loader)


def test_collected_store_matches_jax(setup, jax_trainer, pil_decode,
                                     monkeypatch):
    """The collection pass (both orientations, canvas coordinates, the
    teacher's 4-proposal budget) against JAX's from the same converted
    teacher over two train images, every detection paired to TOL, with
    res5 in f32 on both sides; then with INT8_COLLECT: the pass runs the
    int8 clone (K2s), whose backbone is JAX's int8 backbone bit for bit.

    Why res5 in f32 in the first half: the two packages' f32 backbones
    differ by about 8e-7 (another summation order), so the proposals
    differ by about 2e-5 pixels; the int8 res5 turns that into whole
    quantisation steps on some crops, and scores move by up to 5e-4, in
    JAX run op by op as much as compiled (measured). The teacher of this
    setup keeps two class-0 boxes whose scores sit 4.6e-5 apart and
    overlap above the NMS threshold, so which one survives depends on
    that noise. In f32 the scores agree to 6e-7. The int8 res5's
    inference is held to JAX by the fault test above."""
    from coin_tpu.data.augment import normalize_batch as jnormalize
    from coin_tpu.engine.state import merge_params
    from coin_tpu_torch.models import clip_resnet
    tr = _state_from_jax(_port_trainer(setup), jax_trainer)
    assert tr.teacher_pcfg.post_nms_topk_test == 4
    _collect_two_images((jax_trainer, tr), setup, monkeypatch)
    for t in (jax_trainer, tr):
        monkeypatch.setattr(t.cfg.TPU, "INT8_COLLECT", False)
    monkeypatch.setattr(jax_trainer, "_collect_infer", None)
    int8_teacher, int8_jmodel = tr.state.teacher, jax_trainer.model
    assert int8_teacher.quant_train_res5 == 1
    f32_teacher = int8_teacher.clone(quant_convs=False)
    f32_teacher.set_quant(False, 0)
    tr.state.teacher = f32_teacher
    monkeypatch.setattr(jax_trainer, "model",
                        int8_jmodel.clone(quant_train_res5=0))
    want = jax_trainer.collect_teacher_store()
    got = tr.collect_teacher_store()
    tr.state.teacher = int8_teacher
    monkeypatch.setattr(jax_trainer, "model", int8_jmodel)
    monkeypatch.setattr(jax_trainer, "_collect_infer", None)
    assert sorted(got.image_ids()) == sorted(want.image_ids())
    for image_id in want.image_ids():
        for view in ("RCNN", "RCNN_FLIP"):
            _check_view(got.get_view(image_id, view),
                        want.get_view(image_id, view), f"{image_id}/{view}")

    calls = []
    int8_conv = clip_resnet.int8_conv
    monkeypatch.setattr(clip_resnet, "int8_conv",
                        lambda *a: calls.append(1) or int8_conv(*a))
    tr.cfg.TPU.INT8_COLLECT = True
    store = tr.collect_teacher_store()
    # both orientations through the 45 backbone convs (res5 keeps its
    # training conv: qt wins over quant)
    assert len(calls) == 2 * 45
    assert all(store.has_view(i, v) for i in want.image_ids()
               for v in ("RCNN", "RCNN_FLIP"))
    batch, _ = next(iter(tr._collect_loader))
    with torch.no_grad():
        feats = tr.state.teacher.clone(quant_convs=True).features(
            normalize_batch(torch.from_numpy(batch.images[:1])))
    jm = jax_trainer.model.clone(quant_convs=True)
    with jax.disable_jit():
        jfeats = jm.apply(merge_params(jax_trainer.state.teacher_params,
                                       jax_trainer.state.frozen),
                          jnormalize(jnp.asarray(batch.images[:1])),
                          method="features")
    np.testing.assert_array_equal(feats.numpy(), np.asarray(jfeats))


def _record(trainer, log, names, patch):
    """Replace the steps, the collection pass, the teacher cache and the
    checkpoint writer by recorders (``patch``: monkeypatch.setattr)."""
    def step(name):
        def fn(state, *args):
            log.append((name, int(state.step)))
            if hasattr(state, "replace"):        # the JAX TrainState
                return state.replace(step=state.step + 1), {}
            state.step += 1
            return state, {}
        return fn
    for attr, name in names.items():
        patch(trainer, attr, step(name))
    patch(trainer, "state", trainer.state)
    patch(trainer, "collect_teacher_store",
          lambda: log.append(("collect", None)) or trainer.store)
    patch(trainer, "_pack_offline", lambda batch: batch.online["RCNN"])
    patch(trainer.checkpointer, "save",
          lambda *a, **k: log.append(("save", a[1])))


def test_train_flavor_and_refresh_sequence_matches_jax(setup, jax_trainer,
                                                       pil_decode,
                                                       monkeypatch):
    """Which step runs at each iteration, when the collection pass runs and
    when the burn-up checkpoint is written, over 8 iterations: the cache
    from step 0, burn-up at 2, a refresh every epoch (2 steps)."""
    names = {"_train_step": "live", "_train_step_cached": "cached",
             "_train_step_cached_two": "cached_two"}
    logs = {}
    for key, tr in (("jax", jax_trainer), ("port", _port_trainer(setup))):
        logs[key] = []
        _record(tr, logs[key], names, monkeypatch.setattr)
        tr.train(max_iter=8)
    assert logs["port"] == logs["jax"]
    assert [e[0] for e in logs["jax"]] == [
        "collect", "cached", "cached", "save"] + [
        "collect", "cached_two", "cached_two"] * 3


@pytest.fixture
def out_dir(tmp_path):
    """The trainer's OUTPUT_DIR. Its checkpoints (about half a GB each with
    the full-width trunk) are deleted after the test: pytest keeps the
    temporary directories of its last runs, and they fill the disk."""
    yield tmp_path
    shutil.rmtree(tmp_path / "checkpoints", ignore_errors=True)


def test_train_runs_with_finite_losses(setup, out_dir):
    """``train(max_iter=4)`` on the CPU: a collection pass, 2 cached steps
    of int8 res5, a refresh, 2 cached_two steps; finite losses in
    metrics.json, the burn-up checkpoint, a finite teacher."""
    tr = _port_trainer(setup, OUTPUT_DIR=str(out_dir))
    before = {n: p.detach().clone() for n, p in
              tr.state.model.named_parameters() if p.requires_grad}
    state = tr.train(max_iter=4)
    assert state.step == 4
    rows = [json.loads(line) for line in
            open(os.path.join(str(out_dir), "metrics.json"))]
    losses = [v for r in rows for k, v in r.items() if k.startswith("loss")]
    assert losses and all(np.isfinite(losses))
    assert os.path.exists(os.path.join(str(out_dir), "checkpoints",
                                       "burn_up_0000001"))
    res5 = [n for n in before if n.startswith("res5.")]
    assert res5 and all(not torch.equal(before[n], dict(
        state.model.named_parameters())[n]) for n in res5)
    assert all(bool(torch.isfinite(p).all())
               for p in state.teacher.parameters())


def test_checkpoint_resume_continues_bit_for_bit(setup, out_dir, pil_decode):
    """Save after two steps, resume in a new trainer, and take the same
    step in both: losses, parameters, momentum, teacher, prototypes and the
    generator agree exactly."""
    live = {"CLOUD.BURN_UP_STEP": 1, "TPU.CACHE_TEACHER": False,
            "TPU.TEACHER_REFRESH_EPOCHS": 0}
    tr = _port_trainer(setup, OUTPUT_DIR=str(out_dir), **live)
    tr.train(max_iter=2)
    tr.checkpointer.save(tr.state, 2)
    tr2 = _port_trainer(setup, OUTPUT_DIR=str(out_dir), **live)
    tr2.resume_or_load(resume=True)
    assert tr2.state.step == 2
    batch = tr.train_loader.pack_batch([0, 1], np.array([False, True]))
    batch = tr.train_loader._attach_store(batch)
    from coin_tpu_torch.engine.pre_train import online_view_to_detections
    args = (torch.from_numpy(batch.images), torch.from_numpy(batch.image_hw),
            online_view_to_detections(batch.online["RCNN"], device="cpu"),
            online_view_to_detections(batch.online["RPN"], device="cpu"))
    out = [t._train_step(t.state, *args) for t in (tr, tr2)]
    (s1, l1), (s2, l2) = out
    assert l1.keys() == l2.keys()
    for k in l1:
        assert torch.equal(l1[k], l2[k]), k
    for m in ("model", "teacher", "merge_model"):
        a, b = getattr(s1, m).state_dict(), getattr(s2, m).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), m
    for o in ("optimizer", "merge_optimizer"):
        a, b = (getattr(s, o).momentum_buffers() for s in (s1, s2))
        assert getattr(s1, o).count == getattr(s2, o).count
        assert all(torch.equal(a[k], b[k]) for k in a if a[k] is not None)
    for f in ("proto", "b_online", "b_offline"):
        assert torch.equal(getattr(s1.prototypes, f),
                           getattr(s2.prototypes, f))
    assert torch.equal(s1.generator.get_state(), s2.generator.get_state())


@pytest.mark.parametrize("knob", ["TPU.TEACHER_FAST_HEAD"])
def test_unported_knobs_raise(setup, knob):
    with pytest.raises(NotImplementedError, match=knob.split(".")[1]):
        _port_trainer(setup, **{knob: True})


@pytest.mark.parametrize("knob,value", [
    ("TPU.INT8_ROI", True), ("TPU.TEACHER_SHARE_CROPS", 256),
    ("TPU.TEACHER_SHARE_THRESH", 0.8)])
def test_ported_knobs_build_what_jax_builds(setup, knob, value):
    """TPU.INT8_ROI gives the model (and its int8 clone) ``quant_roi``, and
    TPU.TEACHER_SHARE_CROPS / SHARE_THRESH set the teacher's
    ``share_crops_budget`` / ``share_crops_thresh``, as the JAX trainer
    reads them (coin_tpu/engine/base.py:151, trainer.py:97-99)."""
    tr = _port_trainer(setup, **{knob: value})
    jcfg = setup["jcfg"].clone()
    node, _, leaf = knob.rpartition(".")
    jcfg.get_path(node)[leaf] = value
    jtr = JTrainer(jcfg, store=setup["jstore"])
    assert tr.model.quant_roi == jtr.model.quant_roi
    assert tr.model.clone(quant_convs=True).quant_roi == jtr.model.quant_roi
    for f in ("share_crops_budget", "share_crops_thresh"):
        assert getattr(tr.teacher_pcfg, f) == getattr(jtr.teacher_pcfg, f)
    assert (tr.model.quant_roi, tr.teacher_pcfg.share_crops_budget,
            tr.teacher_pcfg.share_crops_thresh) == {
        "TPU.INT8_ROI": (True, 0, 0.9),
        "TPU.TEACHER_SHARE_CROPS": (False, 256, 0.9),
        "TPU.TEACHER_SHARE_THRESH": (False, 0, 0.8)}[knob]


@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    """One random RN50 checkpoint with a one-layer 128-wide text
    transformer and its BPE merges, shared by both knobs' cases."""
    from coin_tpu_torch.models.manifests import clip_assets
    return clip_assets(str(tmp_path_factory.mktemp("clip")), CLASSES,
                       "realistic", seed=7, text_width=128, text_layers=1)


@pytest.mark.parametrize("knob", ["TPU.CLIP_BPE_VOCAB", "TPU.CLIP_WEIGHTS"])
def test_clip_knobs_build_what_jax_builds(setup, clip_files, knob):
    """TPU.CLIP_WEIGHTS loads OpenAI CLIP's tensors (here a random RN50
    checkpoint with a one-layer 128-wide text transformer) into the
    detector, and TPU.CLIP_BPE_VOCAB (set with the weights, so that the
    text trunk is the same in both packages) gives the CLIP prompt tokens
    of the classes and the template-mean prototypes, as the JAX trainer
    does (coin_tpu/engine/base.py:117-124, 192-213): the same loaded
    tensors and tokens, prototypes within 1e-5 of the largest entry
    (without the vocab the prototypes start from each package's own random
    prompt embeddings)."""
    from coin_tpu_torch.convert_from_jax import from_jax_variables
    ckpt, bpe = clip_files
    over = {"TPU.CLIP_WEIGHTS": ckpt, "TPU.TEXT_WIDTH": 128}
    if knob == "TPU.CLIP_BPE_VOCAB":
        over[knob] = bpe
    tr = _port_trainer(setup, **over)
    jcfg = setup["jcfg"].clone()
    for k, v in over.items():
        node, _, leaf = k.rpartition(".")
        jcfg.get_path(node)[leaf] = v
    jtr = JTrainer(jcfg, store=setup["jstore"])
    np.testing.assert_array_equal(np.asarray(tr.class_tokens),
                                  np.asarray(jtr.class_tokens))
    assert (tr.clip_tokenizer is None) == (knob == "TPU.CLIP_WEIGHTS")
    if knob == "TPU.CLIP_BPE_VOCAB":
        got = tr.state.prototypes.proto.numpy()
        want = np.asarray(jtr.state.prototypes.proto)
        assert got.shape == (3, 1024)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    jparams = from_jax_variables(jax.device_get(jtr.state.frozen))
    jparams.update(from_jax_variables(jax.device_get(jtr.state.params)))
    own = tr.model.state_dict()
    keys = [k for k in own
            if k.split(".")[0] in ("backbone", "res5", "text_trunk")]
    assert len(keys) == 296
    for k in keys:
        assert torch.equal(own[k], jparams[k]), k


def test_int8_clone_shares_the_weights():
    """``clone(quant_convs=True)`` (the collection pass's and INT8_INFERENCE's
    model) switches every backbone conv to K2s, keeps res5's training mode,
    and shares every tensor with the original."""
    from coin_tpu_torch.models.clip_resnet import QConv2d
    from coin_tpu_torch.models.detector import OpenVocabularyRCNN
    model = OpenVocabularyRCNN(num_classes=2, text_layers=1, text_width=32,
                               text_heads=2, quant_train_res5=1)
    twin = model.clone(quant_convs=True)
    for (n, a), (_, b) in zip(model.state_dict(keep_vars=True).items(),
                              twin.state_dict(keep_vars=True).items()):
        assert a is b, n
    convs = [m for m in twin.backbone.modules() if isinstance(m, QConv2d)]
    assert convs and all(m.quant and not m.qt for m in convs)
    res5 = [m for m in twin.res5.modules() if isinstance(m, QConv2d)]
    assert res5 and all(m.quant and m.qt == 1 for m in res5)
    assert not any(m.quant for m in model.modules()
                   if isinstance(m, QConv2d))


class _Built(Exception):
    """Stops a trainer's construction in its base, carrying the cfg."""


@pytest.mark.parametrize("reference", [1, 2])
def test_auto_scale_counts_one_worker(setup, monkeypatch, reference):
    """With four cards visible the port still trains on one, so with
    SOLVER.REFERENCE_WORLD_SIZE set the batch, LR and schedule scale for
    one worker: unchanged at a reference of 1, halved (batch, LR) and
    doubled (schedule) at 2, once although both the trainer and its base
    call ``auto_scale_workers``."""
    from coin_tpu_torch.engine import base, trainer

    def stop(cfg):
        raise _Built(cfg)

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for mod in (base, trainer):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda d="cuda": torch.device(d))
    # the base's check follows its own auto_scale_workers call
    monkeypatch.setattr(base, "check_ported", stop)
    cfg = setup["cfg"].clone()
    cfg.SOLVER.REFERENCE_WORLD_SIZE = reference
    with pytest.raises(_Built) as built:
        CoinTrainer(cfg, store=ResultStore.load(setup["npz"]),
                    device="cuda")
    got, s = built.value.args[0].SOLVER, setup["cfg"].SOLVER
    assert got.REFERENCE_WORLD_SIZE == 1
    assert got.IMG_PER_BATCH_UNLABEL == s.IMG_PER_BATCH_UNLABEL // reference
    assert got.BASE_LR == s.BASE_LR / reference
    assert got.MAX_ITER == s.MAX_ITER * reference
    assert got.WARMUP_ITERS == s.WARMUP_ITERS * reference
    assert list(got.STEPS) == [v * reference for v in s.STEPS]
    assert got.CHECKPOINT_PERIOD == s.CHECKPOINT_PERIOD * reference
