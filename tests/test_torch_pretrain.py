"""The pre-train stage (coin_tpu_torch.engine.pre_train.PRETrainer, stage 2
of a recipe) against the JAX package's on the CPU.

One pre-train step from one JAX ``TrainState`` (no teacher, no CKG),
carried into the port by ``load_train_state``, with JAX's random draws
injected (``StepDraws``: the strong view's (B, 9), the RPN and ROI
priorities of the 2B trained images), against the jitted JAX
``PRETrainer`` step, with the prototype update off and on. The model is
the tiny f32 build of ``tests/test_torch_models.tiny_pair`` (full-width
RN50 trunk, a 2-layer 64-wide text tower, 3 classes) on a 64 x 128
canvas, with CLIPDET_foggy.yaml's solver and loss weights; each JAX step
is compiled once per module and dtype. Tolerances, as
tests/test_torch_train_step.py holds the adaptation step: losses rtol 1e-4
(atol 1e-6); the momentum, the parameter updates and the prototypes to
1e-4 of their largest entry, an update also to the f32 rounding (2 ulp) of
the parameters it moved; counts and steps equal; ``b_online`` and
``b_offline``, which the pre-train leaves alone, equal. One exception, the
momentum of res5's convolutions, held to RES5_MOMENTUM_REL of its largest
entry: their weight gradients sum 4 images' crops with much cancellation,
and oneDNN's convolution backward sums them in an order that follows the
thread count. Measured on these inputs (AMX host): the port against
itself with one thread and with two, 1.25e-4 at
``res5.layer4.1.conv2.weight``; the port against JAX 1.7e-5 with one
thread, 1.25e-4 with two (the fixture's), 5.4e-5 at ``conv1``; every
other momentum within 1.6e-5; the losses within 2.4e-7 of each other.

The bf16 step (f32 masters) is held against JAX's bf16 step compiled with
``xla_allow_excess_precision`` off (why: tests/test_torch_train_step.py),
at BF16_LOSS_REL for the losses and BF16_REL of the largest entry for the
updates, the momentum and the prototypes, 1.5 times the largest reading
on this module's inputs (AMX host: losses 1.0e-2, loss_cls; the updates
and momentum 0.150 of their largest entry, the RPN head's conv bias, as
in the adaptation step's bf16 case; the prototypes 1.8e-7).

The rest: the class loss (plain and clipart's probability-weighted one),
``pack_view(score_thresh)`` and ``TrainLoader(store_thresh)`` against the
JAX package's; ``pretrain_losses`` with clipart's loss and the prototype
update against JAX's jitted one; clipart's switch; ``PRETrainer.train``
on the CPU and the hand-off of its ``pre_train_CLIP_*`` checkpoint to
``CoinTrainer`` through ``MODEL.WEIGHTS`` (tests/test_adaptation_e2e.py's
``test_pretrain_ckpt_loads_into_coin_trainer``); the CLI
(``coin_tpu_torch.tools.train_net``): stages 2 and 3 and an evaluation on
the synthetic set, the dispatch of every ``CLOUD.Trainer`` name, and the
host helpers it prints and seeds with.
"""

import dataclasses
import json
import os
import random
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import coin_tpu.native
import coin_tpu_torch.native
from coin_tpu.data import voc as jvoc
from coin_tpu.data.augment import normalize_batch as jnormalize
from coin_tpu.data.loader import TrainLoader as JTrainLoader
from coin_tpu.engine import coin_pipelines as jcp
from coin_tpu.engine import pre_train as jpre
from coin_tpu.engine import state as jstate
from coin_tpu.evaluation import testing as jtesting
from coin_tpu.models import roi_heads as jrh
from coin_tpu.solver import build as jsolver
from coin_tpu.structures import Detections as JDet
from coin_tpu_torch.config import load_config
from coin_tpu_torch.convert_from_jax import (from_jax_variables,
                                             load_train_state)
from coin_tpu_torch.data import voc as tvoc
from coin_tpu_torch.data.augment import normalize_batch
from coin_tpu_torch.data.loader import TrainLoader
from coin_tpu_torch.engine import base as tbase
from coin_tpu_torch.engine import coin_pipelines as tcp
from coin_tpu_torch.engine import pipelines as tpipe
from coin_tpu_torch.engine import pre_train as tpre
from coin_tpu_torch.engine.results_store import ResultStore
from coin_tpu_torch.engine.step_builder import StepDraws
from coin_tpu_torch.engine.trainer import CoinTrainer
from coin_tpu_torch.evaluation import testing as ttesting
from coin_tpu_torch.models import roi_heads as trh
from coin_tpu_torch.models.detector import OpenVocabularyRCNN
from coin_tpu_torch.structures import Detections
from coin_tpu_torch.tools import train_net
from coin_tpu_torch.utils import setup as tsetup
from tests.test_adaptation_e2e import synth_store
from tests.test_torch_augment import jax_augment_draws
from tests.test_torch_models import CANVAS, NUM_CLASSES, tiny_pair
from tests.test_torch_models import two_torch_threads  # noqa: F401
from tests.test_torch_train_ops import _np, _sampled, _t, priorities
from tests.test_torch_train_step import _close, _flat, _port_cfg, _trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAIN_YAML = os.path.join(REPO, "configs/coin/PRETRAINS/CLIPDET_foggy.yaml")
FAST_YAML = os.path.join(REPO, "configs/coin/GDINO/foggy_fast.yaml")
C = NUM_CLASSES
B = 2
CAP = 8
STEP = 5
REL = 1e-4
RES5_MOMENTUM_REL = 2.5e-4
BF16_LOSS_REL = 1.5e-2
BF16_REL = 0.225
CLASSES = ("car", "person")


def _cfg():
    cfg = load_config(PRETRAIN_YAML)
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def _dets(rng, n_valid):
    """Batched cloud detections with confident probs."""
    xy = rng.uniform(0, 100, (B, CAP, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 40, (B, CAP, 2))], -1)
    boxes[..., 1::2] = np.minimum(boxes[..., 1::2], 63.0)
    classes = rng.randint(0, C, (B, CAP))
    probs = rng.dirichlet(np.ones(C + 1), (B, CAP)) * 0.3
    probs[np.arange(B)[:, None], np.arange(CAP), classes] += 0.7
    valid = np.arange(CAP)[None] < np.asarray(n_valid)[:, None]
    return dict(boxes=boxes.astype(np.float32),
                scores=probs[..., :C].max(-1).astype(np.float32),
                classes=np.where(valid, classes, -1).astype(np.int32),
                valid=valid, probs=probs.astype(np.float32))


# ------------------------------------------------------- one step vs JAX
@pytest.fixture(scope="module")
def setup():
    jmodel, pcfg, tokens, variables, tmodel = tiny_pair()
    cfg = _cfg()
    rng = np.random.RandomState(5)
    params, frozen = jstate.partition_params(
        variables, jstate.default_freeze_predicate(True))
    tx, _ = jsolver.build_optimizer(params, cfg)
    trace = jax.tree.map(lambda p: jnp.asarray(
        1e-3 * rng.randn(*p.shape), jnp.float32), params)
    fields = lambda s: getattr(s, "_fields", ())
    opt_state = tuple(
        s._replace(trace=trace) if "trace" in fields(s) else
        s._replace(count=jnp.asarray(3, jnp.int32))
        if "count" in fields(s) else s for s in tx.init(params))
    # prototypes off the text features (the text-align loss's kink), from
    # the port's copy of the weights: JAX's agree to 5e-8 here, without
    # JAX compiling the text tower op by op
    with torch.no_grad():
        text = tmodel.text_features(torch.from_numpy(
            np.asarray(tokens)).long()).numpy()
    protos = [text + 0.05 * rng.randn(*text.shape).astype(np.float32)
              for _ in range(3)]
    base = jax.tree.map(jnp.asarray, jstate.TrainState(
        params=params, frozen=frozen, opt_state=opt_state,
        step=np.asarray(STEP), rng=jax.random.key(21),
        prototypes=jstate.Prototypes(*protos)))
    weights = tpipe.loss_weights_from(cfg)

    def jstep(model):
        return jpre.PRETrainer._build_train_step(types.SimpleNamespace(
            model=model, pcfg=pcfg, class_tokens=np.asarray(tokens), tx=tx,
            cfg=cfg, loss_weights=weights, prob_weighted=False))

    cells = rng.randint(0, 256, (B, CANVAS[0] // 16, CANVAS[1] // 16, 3))
    images = cells.repeat(16, 1).repeat(16, 2).astype(np.uint8)
    hw = np.asarray([CANVAS, (CANVAS[0], 100)], np.float32)
    inputs = dict(images=images, hw=hw, rcnn=_dets(rng, [6, 5]),
                  rpn=_dets(rng, [7, 4]))
    return types.SimpleNamespace(
        cfg=cfg, pcfg=pcfg, tokens=tokens, base=base, weights=weights,
        steps={"f32": jstep(jmodel),
               "bf16": jstep(jmodel.clone(compute_dtype=jnp.bfloat16))},
        inputs=inputs, variables=variables, jmodel=jmodel)


def _draws(rng_state, pcfg):
    """The values the JAX pre-train step draws from ``state.rng``."""
    _, rng_aug, rng_s, _ = jax.random.split(rng_state, 4)
    rng_rpn, rng_roi = jax.random.split(rng_s)
    anchors = (CANVAS[0] // 16) * (CANVAS[1] // 16) * 15
    cand = pcfg.post_nms_topk_train + CAP
    return StepDraws(
        augment=torch.from_numpy(jax_augment_draws(rng_aug, B)),
        rpn=torch.from_numpy(np.stack([priorities(k, anchors) for k in
                                       jax.random.split(rng_rpn, 2 * B)])),
        roi=torch.from_numpy(np.stack([priorities(k, cand) for k in
                                       jax.random.split(rng_roi, 2 * B)])))


def _port_state(cfg, j0, dtype=torch.float32):
    model = OpenVocabularyRCNN(num_classes=C, text_layers=2, text_width=64,
                               text_heads=2, compute_dtype=dtype)
    proto0 = torch.zeros(np.asarray(j0.prototypes.proto).shape)
    state = tpre.init_pretrain_state(cfg, model, seed=0, proto0=proto0)
    return load_train_state(state, jax.device_get(dataclasses.replace(
        j0, rng=None)))


_RUNS = {}


def run(setup, dtype, update_prototype):
    """(JAX state before, after, JAX losses, port state after, port
    losses) of one step, computed once per module."""
    key = (dtype, update_prototype)
    if key in _RUNS:
        return _RUNS[key]
    s, inp = setup, setup.inputs
    j0 = s.base
    jd = lambda d: JDet(**{k: jnp.asarray(v) for k, v in d.items()})
    td = lambda d: Detections(**{k: torch.from_numpy(v)
                                 for k, v in d.items()})
    args = (jnp.asarray(inp["images"]), jnp.asarray(inp["hw"]),
            jd(inp["rcnn"]), jd(inp["rpn"]), jnp.asarray(update_prototype))
    jstep = s.steps[dtype]
    if dtype == "bf16":
        if "bf16_compiled" not in _RUNS:
            _RUNS["bf16_compiled"] = jstep.lower(j0, *args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        jstep = _RUNS["bf16_compiled"]
    j1, jlosses = jstep(j0, *args)
    state = _port_state(s.cfg, j0, torch.bfloat16 if dtype == "bf16"
                        else torch.float32)
    step = tpre.build_pretrain_step(
        torch.from_numpy(np.asarray(s.tokens)).long(), _port_cfg(s.pcfg),
        s.cfg.CLOUD.PROTOTYPE_UPDATE_WEIGHT, False, s.weights)
    state, tlosses = step(state, torch.from_numpy(inp["images"]),
                          torch.from_numpy(inp["hw"]), td(inp["rcnn"]),
                          td(inp["rpn"]), update_prototype,
                          draws=_draws(j0.rng, s.pcfg))
    _RUNS[key] = (j0, j1, jlosses, state, tlosses)
    return _RUNS[key]


CASES = [("f32", False), ("f32", True), ("bf16", True)]
IDS = ["f32-no_proto_update", "f32-proto_update", "bf16-proto_update"]


@pytest.mark.parametrize("dtype,update_prototype", CASES, ids=IDS)
def test_pretrain_step_losses_match_jax(setup, dtype, update_prototype):
    _, _, jl, state, tl = run(setup, dtype, update_prototype)
    assert set(tl) == set(jl) == {"loss_rpn_cls", "loss_rpn_loc",
                                  "loss_text_align", "loss_cls",
                                  "loss_box_reg"}
    rtol = BF16_LOSS_REL if dtype == "bf16" else REL
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=rtol,
                                   atol=1e-6, err_msg=k)
    assert state.step == STEP + 1
    assert float(jl["loss_cls"]) > 0 and float(jl["loss_rpn_cls"]) > 0
    assert float(jl["loss_box_reg"]) > 0


@pytest.mark.parametrize("dtype,update_prototype", CASES, ids=IDS)
def test_pretrain_step_update_momentum_and_prototypes_match_jax(
        setup, dtype, update_prototype):
    j0, j1, _, state, _ = run(setup, dtype, update_prototype)
    rel = BF16_REL if dtype == "bf16" else REL
    p0, p1 = _flat(j0.params), _flat(j1.params)
    m1 = _flat(_trace(j1.opt_state))
    got = dict(state.model.named_parameters())
    buffers = state.optimizer.momentum_buffers()
    assert set(buffers) == set(p1)
    for name in p1:
        _close(got[name].detach().numpy() - p0[name], p1[name] - p0[name],
               f"update of {name}", base=p0[name], rel=rel)
        m_rel = rel if dtype == "bf16" or not name.startswith("res5.") \
            else RES5_MOMENTUM_REL
        _close(buffers[name].numpy(), m1[name], f"momentum of {name}",
               rel=m_rel)
    assert state.optimizer.count == 4
    proto0 = np.asarray(j0.prototypes.proto)
    want = np.asarray(j1.prototypes.proto)
    assert (np.abs(want - proto0).max() > 0) == update_prototype
    _close(state.prototypes.proto.numpy(), want, "prototype proto",
           rel=rel)
    if not update_prototype:
        np.testing.assert_array_equal(state.prototypes.proto.numpy(), proto0)
    for f in ("b_online", "b_offline"):
        np.testing.assert_array_equal(getattr(state.prototypes, f).numpy(),
                                      np.asarray(getattr(j1.prototypes, f)))
    assert state.teacher is None and state.merge_model is None


def test_load_train_state_carries_a_pretrain_state(setup):
    """The JAX PRETrainer's state (teacher and CKG fields None) loads into
    the port's pre-train state: student and frozen leaves, momentum and
    count, prototypes and step; a state with a teacher refuses it."""
    j0 = setup.base
    state = _port_state(setup.cfg, j0)
    want = _flat(jstate.merge_params(j0.params, j0.frozen))
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    for k, v in _flat(_trace(j0.opt_state)).items():
        np.testing.assert_array_equal(
            state.optimizer.momentum_buffers()[k].numpy(), v, err_msg=k)
    assert state.optimizer.count == 3 and state.step == STEP
    for f in ("proto", "b_online", "b_offline"):
        np.testing.assert_array_equal(getattr(state.prototypes, f).numpy(),
                                      np.asarray(getattr(j0.prototypes, f)))
    adapt = types.SimpleNamespace(model=state.model, teacher=state.model)
    with pytest.raises(ValueError, match="pre-train"):
        load_train_state(adapt, jax.device_get(dataclasses.replace(
            j0, rng=None)))


# --------------------------------------------------------- the losses
@pytest.mark.parametrize("prob_weighted", [False, True],
                         ids=["mil_ce", "prob_weighted"])
def test_class_loss_matches_jax(rng, prob_weighted):
    """The MIL CE of the sampled rows, and clipart's class_cross_loss1
    (fg targets scaled by their largest offline probability, no average
    over the positives), against ``classification_loss`` of the JAX
    package."""
    sp = _sampled(rng)
    scores = (3 * rng.randn(30, C + 1)).astype(np.float32)
    want = jrh.classification_loss(
        scores, jrh.SampledProposals(*map(jnp.asarray, sp)), C, 0.9,
        prob_weighted=prob_weighted)
    got = trh.classification_loss(
        _t(scores), trh.SampledProposals(*map(_t, sp)), C, 0.9,
        prob_weighted=prob_weighted)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    plain = trh.classification_loss(_t(scores),
                                    trh.SampledProposals(*map(_t, sp)), C,
                                    0.9)
    assert (float(got) != float(plain)) == prob_weighted


def test_pretrain_losses_match_jax(setup):
    """``pretrain_losses`` with clipart's probability-weighted class loss
    and the prototype update, on 2 images with JAX's draws, against the
    jitted JAX function: losses rtol 1e-4, the new prototypes to 1e-4 of
    their largest entry."""
    s, inp = setup, setup.inputs
    key = jax.random.key(9)
    rng_rpn, rng_roi = jax.random.split(key)
    jd = lambda d: JDet(**{k: jnp.asarray(v) for k, v in d.items()})
    proto = np.asarray(s.base.prototypes.proto)
    jfn = jax.jit(lambda v, x, hw, rcnn, rpn, p: jcp.pretrain_losses(
        s.jmodel, v, x, hw, rcnn, rpn, p, s.tokens, key, s.pcfg,
        jnp.asarray(True), 0.9, True, s.weights))
    want, want_proto = jfn(s.variables, jnormalize(jnp.asarray(
        inp["images"])), jnp.asarray(inp["hw"]), jd(inp["rcnn"]),
        jd(inp["rpn"]), jnp.asarray(proto))

    model = OpenVocabularyRCNN(num_classes=C, text_layers=2, text_width=64,
                               text_heads=2)
    model.load_state_dict(from_jax_variables(s.variables), strict=True)
    td = lambda d: Detections(**{k: torch.from_numpy(v)
                                 for k, v in d.items()})
    anchors = (CANVAS[0] // 16) * (CANVAS[1] // 16) * 15
    pr = lambda k, n: torch.from_numpy(np.stack(
        [priorities(kk, n) for kk in jax.random.split(k, B)]))
    with torch.no_grad():
        got, got_proto = tcp.pretrain_losses(
            model, normalize_batch(torch.from_numpy(inp["images"])),
            torch.from_numpy(inp["hw"]), td(inp["rcnn"]), td(inp["rpn"]),
            torch.from_numpy(proto),
            torch.from_numpy(np.asarray(s.tokens)).long(),
            pr(rng_rpn, anchors), pr(rng_roi, s.pcfg.post_nms_topk_train
                                     + CAP),
            _port_cfg(s.pcfg), True, 0.9, True, s.weights)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=REL,
                                   atol=1e-6, err_msg=k)
    want_proto = np.asarray(want_proto)
    assert np.abs(want_proto - proto).max() > 0
    _close(got_proto.numpy(), want_proto, "new prototypes")


# ------------------------------------------------ loader, store, trainer
def _settings(cfg, root, out):
    """tests/test_torch_trainer.py's tiny settings, in f32 without the
    int8 knobs."""
    cfg.DATASETS.ROOT = str(root)
    cfg.DATASETS.TRAIN_UNLABEL = ["psynthtrain"]
    cfg.DATASETS.TEST = ["psynthval"]
    cfg.OUTPUT_DIR = str(out)
    cfg.SOLVER.IMG_PER_BATCH_UNLABEL = 2
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.STEPS = [100]
    cfg.SOLVER.FACTOR_LIST = [1, 0.1]
    cfg.SOLVER.CHECKPOINT_PERIOD = 1000
    cfg.TEST.EVAL_PERIOD = 1000
    cfg.TEST.DETECTIONS_PER_IMAGE = 8
    cfg.INPUT.MIN_SIZE_TRAIN = 64
    cfg.INPUT.MIN_SIZE_TEST = 64
    cfg.INPUT.MAX_SIZE = 96
    rpn = cfg.MODEL.RPN
    rpn.PRE_NMS_TOPK_TRAIN = rpn.PRE_NMS_TOPK_TEST = 64
    rpn.POST_NMS_TOPK_TRAIN = rpn.POST_NMS_TOPK_TEST = 16
    rpn.BATCH_SIZE_PER_IMAGE = 16
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
    cfg.TPU.INT8_TRAIN = False
    cfg.TPU.INT8_COLLECT = False
    cfg.TPU.CACHE_TEACHER = False
    cfg.CLOUD.BURN_UP_STEP = 2
    cfg.CLOUD.PROTOTYPE_UPDATE_START = 1
    cfg.CLOUD.CLASSES_WEIGHT = [1.0, 1.0, 0.9]
    return cfg


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    jvoc.make_synthetic_voc(str(root / "synth/VOC2007"), num_images=4,
                            split="train")
    jvoc.make_synthetic_voc(str(root / "synth/VOC2007"), num_images=4,
                            split="val", seed=7)
    for reg in (jvoc.register_pascal_voc, tvoc.register_pascal_voc):
        reg("psynthtrain", "synth/VOC2007", "train", CLASSES, ".jpg")
        reg("psynthval", "synth/VOC2007", "val", CLASSES, ".jpg")
    records = jvoc.load_voc_instances(str(root / "synth/VOC2007"), "train",
                                      CLASSES, ".jpg")
    jstore = synth_store(records, num_classes=len(CLASSES))
    npz = str(root / "CLIP_collect.npz")
    jstore.save(npz)
    return dict(root=root, jstore=jstore, npz=npz)


@pytest.mark.parametrize("thresh", [None, 0.87, 0.9])
def test_pack_view_score_thresh_matches_jax(data, thresh):
    """``pack_view(..., score_thresh)`` keeps the rows the JAX store keeps,
    rescaled, flipped and padded alike (the synthetic store's 7 scores
    a view lie in 0.86-0.91)."""
    store, jstore = ResultStore.load(data["npz"]), data["jstore"]
    kept = total = 0
    for image_id in jstore.image_ids():
        for view in ("RCNN", "RPN"):
            want = jstore.pack_view(image_id, view, 8, 0.75, True, 90.0,
                                    thresh)
            got = store.pack_view(image_id, view, 8, 0.75, True, 90.0,
                                  thresh)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            kept += int(want["valid"].sum())
            total += min(len(jstore.get_view(image_id, view)["scores"]), 8)
    assert 0 < kept and (kept < total) == (thresh is not None)


def test_train_loader_store_thresh_matches_jax(data, monkeypatch):
    """TrainLoader(store_thresh=0.88): the packed cloud views of the first
    batches are the JAX loader's. Both loaders decode with PIL, the
    native decoder patched off in each (tests/test_torch_native.py holds
    the native path)."""
    monkeypatch.setattr(coin_tpu.native, "available", lambda: False)
    monkeypatch.setattr(coin_tpu_torch.native, "available", lambda: False)
    kw = dict(batch_size=2, seed=11, min_size=64, max_size=96, store_cap=8,
              store_thresh=0.88)
    jl = JTrainLoader("psynthtrain", str(data["root"]),
                      store=data["jstore"], **kw)
    tl = TrainLoader("psynthtrain", str(data["root"]),
                     store=ResultStore.load(data["npz"]), **kw)
    for jb, tb in zip([b for _, b in zip(range(3), iter(jl))],
                      [b for _, b in zip(range(3), iter(tl))]):
        assert tb.image_ids == jb.image_ids
        for view in ("RCNN", "RPN"):
            for k, v in jb.online[view].items():
                np.testing.assert_array_equal(tb.online[view][k], v,
                                              err_msg=f"{view}/{k}")


class _Built(Exception):
    """Stops a trainer's construction, carrying the trainer."""


class _LoaderArgs:
    def __init__(self, *args, **kw):
        self.kw = kw


@pytest.mark.parametrize("train_set", ["cliparttrain", "foggytrain_0.02"])
def test_clipart_switch_matches_jax(monkeypatch, train_set):
    """DATASETS.TRAIN_UNLABEL ("cliparttrain",) turns on the
    probability-weighted class loss and packs only the rows scoring 0.5
    or more, in both packages; any other set neither."""
    cfg = load_config(PRETRAIN_YAML)
    cfg.DATASETS.TRAIN_UNLABEL = [train_set]
    seen = {}
    for name, mod, base_cls in (("jax", jpre, jpre.DetectorTrainerBase),
                                ("port", tpre, tbase.DetectorTrainerBase)):
        def base_init(self, cfg, class_tokens=None, train_loader=None,
                      **kw):
            self.train_loader, self.model = train_loader, None

        def stop(self, *a, **kw):
            raise _Built(self)
        monkeypatch.setattr(mod, "TrainLoader", _LoaderArgs)
        monkeypatch.setattr(base_cls, "__init__", base_init)
        monkeypatch.setattr(base_cls, "init_variables" if name == "jax"
                            else "init_prototypes", stop, raising=False)
        device = {"device": "cpu"} if name == "port" else {}
        with pytest.raises(_Built) as built:
            mod.PRETrainer(cfg.clone(), store=ResultStore(8), **device)
        tr = built.value.args[0]
        seen[name] = (tr.prob_weighted, tr.train_loader.kw["store_thresh"])
    assert seen["port"] == seen["jax"] == (
        (True, 0.5) if train_set == "cliparttrain" else (False, None))


def _snapshot(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()
            if p.requires_grad}


def _yaml(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(tsetup._plain(cfg), f)
    return str(path)


@pytest.fixture(scope="module")
def chain(data, tmp_path_factory):
    """Stages 2 and 3 through ``train_net.main`` with ``--device cpu``,
    run once for the module's two tests of them: CLIPDET_foggy.yaml's
    PRETrainer for 3 steps (``SOLVER.MAX_ITER 3`` on the command line)
    with PROTOTYPE_UPDATE_START 1, its prototypes recorded around each
    step; foggy_fast.yaml's CoinTrainer (f32, no int8 knobs) for one step
    from ``pre_train_CLIP_0000003`` through MODEL.WEIGHTS, its state
    compared with the pre-trained one just after the load; then
    ``--eval-only`` of the pre-trained student through ``ModelZoo_test``.
    The checkpoints (over 300 MB each with the full-width trunk) are
    deleted afterwards."""
    out = tmp_path_factory.mktemp("chain")
    pre = _settings(load_config(PRETRAIN_YAML), data["root"], out / "pre")
    pre.CLOUD.COLLECT_FILE = data["npz"]
    adapt = _settings(load_config(FAST_YAML), data["root"], out / "adapt")
    adapt.CLOUD.COLLECT_FILE = data["npz"]
    adapt.SOLVER.MAX_ITER = 1
    got = {"protos": []}
    build = tpre.build_pretrain_step
    load = CoinTrainer.resume_or_load

    def recording_build(*args, **kw):
        step = build(*args, **kw)

        def recorded(state, *a, **k):
            if not got["protos"]:
                got["protos"].append(state.prototypes.proto.clone())
                got["before"] = _snapshot(state.model)
            new = step(state, *a, **k)
            got["protos"].append(new[0].prototypes.proto.clone())
            return new
        return recorded

    def recording_load(self, resume=False):
        load(self, resume)
        want = got["pre"].state.model.state_dict()
        same = lambda m: set(m.state_dict()) == set(want) and all(
            torch.equal(v, want[k]) for k, v in m.state_dict().items())
        got["handoff"] = dict(
            step=self.state.step, student=same(self.state.model),
            teacher=same(self.state.teacher), proto=torch.equal(
                self.state.prototypes.proto,
                got["pre"].state.prototypes.proto))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpre, "build_pretrain_step", recording_build)
        got["pre"] = train_net.main([
            "--config", _yaml(out / "pre.yaml", pre), "--device", "cpu",
            "SOLVER.MAX_ITER", "3"])
    got["ckpt"] = os.path.join(pre.OUTPUT_DIR, "checkpoints",
                               "pre_train_CLIP_0000003")
    got["ckpt_keys"] = set(got["pre"].checkpointer.load_tree(got["ckpt"]))
    adapt_yaml = _yaml(out / "adapt.yaml", adapt)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CoinTrainer, "resume_or_load", recording_load)
        got["adapt"] = train_net.main(["--config", adapt_yaml, "--device",
                                       "cpu", "MODEL.WEIGHTS", got["ckpt"]])
    got["eval"] = train_net.main([
        "--config", adapt_yaml, "--device", "cpu", "--eval-only",
        "CLOUD.Trainer", "ModelZoo_test", "MODEL.WEIGHTS", got["ckpt"]])
    got["pre_cfg"] = pre
    yield got
    for d in ("pre/checkpoints", "adapt/checkpoints", "pre/code_snapshot",
              "adapt/code_snapshot"):
        shutil.rmtree(out / d, ignore_errors=True)


def test_pretrainer_trains_and_hands_off_to_coin_trainer(chain):
    """Stage 2 of ``chain``, ``PRETrainer.train`` to MAX_ITER 3 with
    PROTOTYPE_UPDATE_START 1: three steps, trainable parameters that move,
    prototypes that stay at step 0 and move from step 1, finite losses and
    the ``pre_train_CLIP_0000003`` checkpoint without teacher or CKG; the
    CoinTrainer with MODEL.WEIGHTS at it starts at step 0 with the
    student and the teacher both equal to the pre-trained weights, and
    its prototypes (tests/test_adaptation_e2e.py's hand-off in JAX)."""
    tr, protos = chain["pre"], chain["protos"]
    state = tr.state
    assert isinstance(tr, tpre.PRETrainer) and not tr.prob_weighted
    assert state.teacher is None
    assert state.step == 3 and len(protos) == 4
    assert torch.equal(protos[1], protos[0])
    assert not torch.equal(protos[2], protos[1])
    assert not torch.equal(protos[3], protos[2])
    assert all(not torch.equal(chain["before"][n], p) for n, p in
               state.model.named_parameters() if n.startswith("res5."))
    rows = [json.loads(line) for line in
            open(os.path.join(tr.cfg.OUTPUT_DIR, "metrics.json"))]
    assert all(np.isfinite(v) for r in rows for k, v in r.items()
               if k.startswith("loss"))
    assert os.path.exists(chain["ckpt"])
    assert {"model", "optimizer", "prototypes", "step",
            "generator"} <= chain["ckpt_keys"]
    assert not {"teacher", "merge_model"} & chain["ckpt_keys"]
    assert chain["handoff"] == dict(step=0, student=True, teacher=True,
                                    proto=True)


def test_cli_runs_stages_two_and_three_on_cpu(chain):
    """``train_net.main`` with ``--device cpu`` (``chain``): stage 2 writes
    its config snapshot and checkpoint, stage 3 returns a CoinTrainer one
    step on from the pre-trained weights, and ``--eval-only`` returns AP,
    AP50 and AP75 within [0, 100]."""
    pre = chain["pre_cfg"]
    assert os.path.exists(os.path.join(pre.OUTPUT_DIR, "config.yaml"))
    coin = chain["adapt"]
    assert isinstance(coin, CoinTrainer) and coin.state.step == 1
    want = chain["pre"].state.model.state_dict()
    assert [n for n, p in coin.state.model.named_parameters()
            if p.requires_grad and not torch.equal(p, want[n])]
    results = chain["eval"]
    assert {"AP", "AP50", "AP75"} <= set(results)
    assert all(0.0 <= results[k] <= 100.0 for k in ("AP", "AP50", "AP75"))


class _Stub:
    def __init__(self, *args, **kw):
        self.args, self.kw = args, kw


@pytest.mark.parametrize("name", ["PRETrainer", "CoinTrainer",
                                  "ModelZoo_test", "GDINO_test",
                                  "GLIP_test", "CLIP_test"])
def test_cli_dispatches_every_trainer_name(monkeypatch, name):
    """``build_trainer`` maps each CLOUD.Trainer name as train_net.py
    does, on the caller's device (the trainers and the eval trainers
    replaced by recorders, so no model is built)."""
    from coin_tpu_torch.engine import test as ttest
    from coin_tpu_torch.engine import trainer as ttrainer
    monkeypatch.setattr(tpre, "PRETrainer", type("P", (_Stub,), {}))
    monkeypatch.setattr(ttrainer, "CoinTrainer", type("T", (_Stub,), {}))
    monkeypatch.setattr(ttest, "build_eval_trainer",
                        lambda cfg, n, device: ("eval", n, device))
    tvoc.register_pascal_voc("psynthval", "synth/VOC2007", "val", CLASSES,
                             ".jpg")
    cfg = load_config(PRETRAIN_YAML)
    cfg.CLOUD.Trainer = name
    cfg.DATASETS.TEST = ["psynthval"]
    got = train_net.build_trainer(cfg, "cpu")
    if name.endswith("_test") and name != "ModelZoo_test":
        assert got == ("eval", name, "cpu")
        return
    want = {"PRETrainer": "P", "CoinTrainer": "T", "ModelZoo_test": "T"}
    assert type(got).__name__ == want[name]
    assert got.args[0] is cfg and got.kw["device"] == "cpu"
    if name == "ModelZoo_test":
        store = got.kw["store"]
        assert isinstance(store, ResultStore) and len(store) == 0 \
            and store.num_classes == len(CLASSES)


@pytest.mark.parametrize("name,error,match", [
    ("OracleTrainer", None, None),
    ("NoSuchTrainer", ValueError, "unknown CLOUD.Trainer")])
def test_cli_refuses_oracle_and_unknown_names(monkeypatch, name, error,
                                              match):
    """An unknown CLOUD.Trainer name raises; OracleTrainer, once refused
    here, is now dispatched on the caller's device (the trainer replaced
    by a recorder, so no model is built)."""
    from coin_tpu_torch.engine import oracle as toracle
    monkeypatch.setattr(toracle, "OracleTrainer", type("O", (_Stub,), {}))
    cfg = load_config(PRETRAIN_YAML)
    cfg.CLOUD.Trainer = name
    if error is None:
        got = train_net.build_trainer(cfg, "cpu")
        assert type(got).__name__ == "O" and got.args[0] is cfg \
            and got.kw["device"] == "cpu"
        return
    with pytest.raises(error, match=match):
        train_net.build_trainer(cfg, "cpu")


def test_cli_test_trainers_only_evaluate(data, tmp_path, monkeypatch,
                                         capsys):
    """A *_test trainer, which has no ``train``, runs as ``--eval-only``
    and prints the JAX package's table of its results (``--num-gpus 1``:
    in this process, no process group)."""
    from coin_tpu_torch.engine import test as ttest
    results = {"AP": 12.5, "AP50": 30.25, "AP75": 10.0, "AP50-car": 40.5,
               "AP50-person": 20.0}
    calls = []

    class Eval:
        def resume_or_load(self, resume=False):
            calls.append(("load", resume))

        def test(self):
            calls.append(("test",))
            return results
    monkeypatch.setattr(ttest, "build_eval_trainer",
                        lambda cfg, n, device: Eval())
    cfg = load_config(PRETRAIN_YAML)
    cfg.CLOUD.Trainer = "GDINO_test"
    cfg.OUTPUT_DIR = str(tmp_path / "eval")
    got = train_net.main(["--config", _yaml(tmp_path / "e.yaml", cfg),
                          "--device", "cpu", "--num-gpus", "1"])
    assert got == results and calls == [("load", False), ("test",)]
    assert jtesting.print_csv_format(results) in capsys.readouterr().out
    shutil.rmtree(tmp_path / "eval" / "code_snapshot", ignore_errors=True)


@pytest.mark.parametrize("per_class", [False, True])
def test_print_csv_format_matches_jax(per_class):
    results = {"AP": 12.3456, "AP50": 45.6789, "AP75": 0.0}
    if per_class:
        results.update({"AP50-car": 50.0, "AP50-person": 41.3578})
    assert ttesting.print_csv_format(results) == \
        jtesting.print_csv_format(results)


@pytest.mark.parametrize("expected", [
    [], [("AP50", 45.6, 0.1)], [("AP50", 40.0, 0.1)], [("AP90", 1.0, 1.0)]])
def test_verify_results_matches_jax(expected):
    """Both pass (True) or both exit with code 1."""
    results = {"AP": 12.3, "AP50": 45.65}
    try:
        want = jtesting.verify_results(expected, results)
    except SystemExit as e:
        assert e.code == 1
        with pytest.raises(SystemExit) as got:
            ttesting.verify_results(expected, results)
        assert got.value.code == 1
    else:
        assert want is True
        assert ttesting.verify_results(expected, results) is True


def test_seed_all_seeds_python_numpy_and_torch():
    draws = []
    for _ in range(2):
        tsetup.seed_all(42)
        draws.append((random.random(), np.random.rand(),
                      torch.rand(()).item()))
    assert draws[0] == draws[1]
    assert os.environ["PYTHONHASHSEED"] == "42"
