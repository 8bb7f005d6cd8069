"""The oracle (coin_tpu_torch.engine.oracle.OracleTrainer, the supervised
upper bound of ``configs/coin/ORACLE/*.yaml``) against the JAX package's
on the CPU.

One oracle step from one JAX ``TrainState`` (no teacher, no CKG net, no
prototypes), carried into the port by ``load_train_state``, with JAX's
random draws injected (``StepDraws`` of one view: the strong view's
(B, 9), then the RPN and ROI priorities of the B images, in JAX's split
order ``rng, rng_aug, rng_step``, then ``rng_rpn, rng_roi``, then per
image), against the jitted JAX ``OracleTrainer`` step built from
``OracleTrainer._build_train_step`` on a namespace. The model is
tests/test_oracle_e2e.py's (full-width RN50 trunk, a 1-layer 32-wide text
tower, car and person) on a 64 x 96 canvas, with ORACLE/foggy.yaml's
solver at BASE_LR 0.01 and no warmup, and 16 sampled RoIs per image of
16 proposals and 8 gt boxes. Cases: f32, and bf16 (f32 masters) with the
shipped class-agnostic head, the JAX bf16 step compiled with
``xla_allow_excess_precision`` off (tests/test_torch_train_step.py says
why). The bounds are tests/test_torch_pretrain.py's, imported from it:
losses rtol REL (atol 1e-6); updates and momentum REL of their largest
entry (an update also 2 ulp of the parameters it moved), res5's momentum
RES5_MOMENTUM_REL (oneDNN's backward order, as there); bf16 BF16_LOSS_REL
and BF16_REL. One bound goes beyond those, with its cause: in bf16 the
updates and momentum of layer3's convolutions are held to
BF16_LAYER3_REL of their largest entry, 1.5 times the largest reading on
this module's inputs (AMX host): 0.2254 at ``backbone.layer3.2.conv3.weight``
(0.1542 at ``layer3.3.conv3``, every other tensor within 0.123). Each
package's own bf16 step lies away from its own f32 step there, JAX's by
0.146 of the largest entry and the port's by 0.079, in opposite
directions, while the two f32 steps agree to 1.6e-4: the weight gradient
of layer3's last 1 x 1 convolutions sums 2 small images' positions with
much cancellation, and bf16's rounding of the gradients flowing in moves
it in each package by its own rounding places.
``oracle_train_losses`` of a per-class detector (``box_reg_classes`` = C,
its (D, 4 · C) ``bbox_pred`` in place of the shipped head's) is held
against JAX's jitted one at rtol REL.

Then the oracle through the port's CLI (``train_net.main`` with
``--device cpu``) on the synthetic VOC set: 3 steps, an eval that writes
``detections.pckl``, the checkpoint and ``--eval-only --resume``; and 2
steps with per-class regression, the cosine schedule and clipping.
"""

import dataclasses
import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coin_tpu.config import load_config as jload_config
from coin_tpu.data.augment import normalize_batch as jnormalize
from coin_tpu.engine import base as jbase
from coin_tpu.engine import oracle as joracle
from coin_tpu.engine import pipelines as jpipe
from coin_tpu.engine import state as jstate
from coin_tpu.engine.common import simple_class_tokens
from coin_tpu.models.detector import OpenVocabularyRCNN as JRCNN
from coin_tpu.solver import build as jsolver
from coin_tpu.structures import Detections as JDet
from coin_tpu_torch.config import load_config
from coin_tpu_torch.convert_from_jax import (from_jax_variables,
                                             load_train_state)
from coin_tpu_torch.data import voc as tvoc
from coin_tpu_torch.data.augment import normalize_batch
from coin_tpu_torch.engine import oracle as toracle
from coin_tpu_torch.engine import pipelines as tpipe
from coin_tpu_torch.engine.step_builder import StepDraws
from coin_tpu_torch.evaluation.dump import evaluate_pkl
from coin_tpu_torch.models.detector import OpenVocabularyRCNN
from coin_tpu_torch.structures import Detections
from coin_tpu_torch.tools import train_net
from tests.test_torch_augment import jax_augment_draws
from tests.test_torch_models import _init_leaf
from tests.test_torch_models import two_torch_threads  # noqa: F401
from tests.test_torch_pretrain import (BF16_LOSS_REL, BF16_REL, REL,
                                       RES5_MOMENTUM_REL, _snapshot)
from tests.test_torch_train_ops import priorities
from tests.test_torch_train_step import _close, _flat, _port_cfg, _trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE_YAML = os.path.join(REPO, "configs/coin/ORACLE/foggy.yaml")
CLASSES = ("car", "person")
C = len(CLASSES)
CANVAS = (64, 96)
B = 2
G = 8
STEP = 5
BF16_LAYER3_REL = 0.34


def _tiny(cfg):
    """tests/test_oracle_e2e.py's settings."""
    cfg.INPUT.MIN_SIZE_TRAIN = cfg.INPUT.MIN_SIZE_TEST = 64
    cfg.INPUT.MAX_SIZE = 96
    rpn = cfg.MODEL.RPN
    rpn.PRE_NMS_TOPK_TRAIN = rpn.PRE_NMS_TOPK_TEST = 64
    rpn.POST_NMS_TOPK_TRAIN = rpn.POST_NMS_TOPK_TEST = 16
    rpn.BATCH_SIZE_PER_IMAGE = 16
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.TEST.DETECTIONS_PER_IMAGE = 8
    cfg.TPU.TEXT_LAYERS = 1
    cfg.TPU.TEXT_WIDTH = 32
    cfg.TPU.TEXT_HEADS = 2
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 0
    return cfg


def _jax_variables(jmodel, seed):
    """Numpy weights for ``jmodel`` (its tree from ``jax.eval_shape``)."""
    shapes = jax.eval_shape(
        jmodel.init, jax.random.key(0), jnp.zeros((1, *CANVAS, 3)),
        jnp.asarray(simple_class_tokens(C + 1)), jnp.zeros((1, 1, 4)))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(_init_leaf(rng, p, s.shape), np.float32),
        shapes)


def _gt(rng):
    xy = rng.uniform(0, 60, (B, G, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(12, 36, (B, G, 2))], -1)
    boxes[..., 1::2] = np.minimum(boxes[..., 1::2], 63.0)
    valid = np.arange(G)[None] < np.asarray([[5], [3]])
    classes = np.where(valid, rng.randint(0, C, (B, G)), -1)
    return dict(boxes=boxes.astype(np.float32), classes=classes.astype(
        np.int32), valid=valid)


@pytest.fixture(scope="module")
def setup():
    jcfg = _tiny(jload_config(ORACLE_YAML))
    cfg = _tiny(load_config(ORACLE_YAML))
    jmodel = JRCNN(num_classes=C, text_layers=1, text_width=32, text_heads=2)
    variables = _jax_variables(jmodel, 0)
    pcfg = jbase.pipeline_config_from(jcfg, C)
    tokens = np.asarray(simple_class_tokens(C + 1))
    params, frozen = jstate.partition_params(
        variables, jstate.default_freeze_predicate(
            jcfg.CLOUD.UPDATE_BACKBONE, jcfg.MODEL.BACKBONE.FREEZE_AT))
    tx, _ = jsolver.build_optimizer(params, jcfg)
    rng = np.random.RandomState(5)
    trace = jax.tree.map(lambda p: jnp.asarray(
        1e-3 * rng.randn(*p.shape), jnp.float32), params)
    fields = lambda s: getattr(s, "_fields", ())
    opt_state = tuple(
        s._replace(trace=trace) if "trace" in fields(s) else
        s._replace(count=jnp.asarray(3, jnp.int32))
        if "count" in fields(s) else s for s in tx.init(params))
    base = jax.tree.map(jnp.asarray, jstate.TrainState(
        params=params, frozen=frozen, opt_state=opt_state,
        step=np.asarray(STEP), rng=jax.random.key(21)))

    def jstep(model):
        return joracle.OracleTrainer._build_train_step(
            types.SimpleNamespace(model=model, pcfg=pcfg, class_tokens=tokens,
                                  tx=tx))

    cells = rng.randint(0, 256, (B, CANVAS[0] // 16, CANVAS[1] // 16, 3))
    images = cells.repeat(16, 1).repeat(16, 2).astype(np.uint8)
    hw = np.asarray([CANVAS, (CANVAS[0], 80)], np.float32)
    return types.SimpleNamespace(
        cfg=cfg, pcfg=pcfg, tokens=tokens, base=base, variables=variables,
        steps={"f32": jstep(jmodel),
               "bf16": jstep(jmodel.clone(compute_dtype=jnp.bfloat16))},
        images=images, hw=hw, gt=_gt(rng))


def _draws(rng_state, pcfg):
    """The values the JAX oracle step draws from ``state.rng``."""
    _, rng_aug, rng_step = jax.random.split(rng_state, 3)
    rng_rpn, rng_roi = jax.random.split(rng_step)
    anchors = (CANVAS[0] // 16) * (CANVAS[1] // 16) * 15
    cand = pcfg.post_nms_topk_train + G
    per_image = lambda k, n: torch.from_numpy(np.stack(
        [priorities(kk, n) for kk in jax.random.split(k, B)]))
    return StepDraws(
        augment=torch.from_numpy(jax_augment_draws(rng_aug, B)),
        rpn=per_image(rng_rpn, anchors), roi=per_image(rng_roi, cand))


def _port_state(cfg, j0, dtype=torch.float32):
    model = OpenVocabularyRCNN(num_classes=C, text_layers=1, text_width=32,
                               text_heads=2, compute_dtype=dtype)
    state = toracle.init_oracle_state(cfg, model, seed=0)
    return load_train_state(state, jax.device_get(dataclasses.replace(
        j0, rng=None)))


def _port_gt(gt):
    return Detections(boxes=torch.from_numpy(gt["boxes"]),
                      scores=torch.ones(B, G),
                      classes=torch.from_numpy(gt["classes"]),
                      valid=torch.from_numpy(gt["valid"]))


_RUNS = {}


def run(setup, dtype):
    """(JAX state before, after, JAX losses, port state after, port
    losses) of one step, computed once per module."""
    if dtype in _RUNS:
        return _RUNS[dtype]
    s, j0 = setup, setup.base
    args = (jnp.asarray(s.images), jnp.asarray(s.hw),
            jnp.asarray(s.gt["boxes"]), jnp.asarray(s.gt["classes"]),
            jnp.asarray(s.gt["valid"]))
    jstep = s.steps[dtype]
    if dtype == "bf16":
        jstep = jstep.lower(j0, *args).compile(
            compiler_options={"xla_allow_excess_precision": False})
    j1, jlosses = jstep(j0, *args)
    if "draws" not in _RUNS:   # both dtypes' steps start from one state
        _RUNS["draws"] = _draws(j0.rng, s.pcfg)
    state = _port_state(s.cfg, j0, torch.bfloat16 if dtype == "bf16"
                        else torch.float32)
    step = toracle.build_oracle_step(torch.from_numpy(s.tokens).long(),
                                     _port_cfg(s.pcfg))
    state, tlosses = step(state, torch.from_numpy(s.images),
                          torch.from_numpy(s.hw), _port_gt(s.gt),
                          draws=_RUNS["draws"])
    _RUNS[dtype] = (j0, j1, jlosses, state, tlosses)
    return _RUNS[dtype]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_oracle_step_losses_match_jax(setup, dtype):
    _, _, jl, state, tl = run(setup, dtype)
    assert set(tl) == set(jl) == {"loss_rpn_cls", "loss_rpn_loc",
                                  "loss_cls", "loss_box_reg"}
    rtol = BF16_LOSS_REL if dtype == "bf16" else REL
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=rtol,
                                   atol=1e-6, err_msg=k)
    assert state.step == STEP + 1
    assert float(jl["loss_cls"]) > 0 and float(jl["loss_box_reg"]) > 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_oracle_step_update_and_momentum_match_jax(setup, dtype):
    """The summed, unweighted losses' update: every trainable parameter's
    change and momentum, the update count; frozen leaves (stem, layer1,
    FrozenBN, the text trunk) unchanged."""
    j0, j1, _, state, _ = run(setup, dtype)
    p0, p1 = _flat(j0.params), _flat(j1.params)
    m1 = _flat(_trace(j1.opt_state))
    got = dict(state.model.named_parameters())
    buffers = state.optimizer.momentum_buffers()
    assert set(buffers) == set(p1)
    for name in p1:
        if dtype == "f32":
            rel = REL
            m_rel = RES5_MOMENTUM_REL if name.startswith("res5.") else REL
        else:
            rel = m_rel = BF16_LAYER3_REL if name.startswith(
                "backbone.layer3.") else BF16_REL
        _close(got[name].detach().numpy() - p0[name], p1[name] - p0[name],
               f"update of {name}", base=p0[name], rel=rel)
        _close(buffers[name].numpy(), m1[name], f"momentum of {name}",
               rel=m_rel)
    assert state.optimizer.count == 4
    frozen = _flat(j0.frozen)
    assert any(k.startswith("backbone.layer1.") for k in frozen)
    sd = state.model.state_dict()
    for k, v in frozen.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert state.prototypes is None and state.teacher is None


def test_load_train_state_carries_an_oracle_state(setup):
    """The JAX OracleTrainer's state (no prototypes) loads into the port's
    oracle state; a pre-train state (with prototypes) refuses it."""
    from coin_tpu_torch.engine import pre_train as tpre
    j0 = setup.base
    state = _port_state(setup.cfg, j0)
    assert state.optimizer.count == 3 and state.step == STEP
    want = _flat(jstate.merge_params(j0.params, j0.frozen))
    got = state.model.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model = OpenVocabularyRCNN(num_classes=C, text_layers=1, text_width=32,
                               text_heads=2)
    pre = tpre.init_pretrain_state(setup.cfg, model, 0,
                                   proto0=torch.zeros(C + 1, 1024))
    with pytest.raises(ValueError, match="oracle"):
        load_train_state(pre, jax.device_get(dataclasses.replace(
            j0, rng=None)))


def test_oracle_train_losses_per_class_match_jax(setup):
    """``oracle_train_losses`` of a per-class detector (``box_reg_classes``
    = C, (D, 4 · C) ``bbox_pred`` carried by ``from_jax_variables``) on the
    normalised images with JAX's draws, against the jitted JAX function:
    the RPN labelled and the RoIs sampled against the ground truth alone,
    CE on the offline class, per-class box regression on it."""
    s = setup
    jmodel = JRCNN(num_classes=C, text_layers=1, text_width=32, text_heads=2,
                   box_reg_classes=C)
    rng = np.random.RandomState(1)
    head = {"kernel": (3e-3 * rng.randn(2048, 4 * C)).astype(np.float32),
            "bias": (0.1 * rng.randn(4 * C)).astype(np.float32)}
    params = dict(s.variables["params"])
    params["box_predictor"] = dict(params["box_predictor"], bbox_pred=head)
    variables = dict(s.variables, params=params)
    key = jax.random.key(9)
    gt = JDet(boxes=jnp.asarray(s.gt["boxes"]),
              scores=jnp.ones((B, G), jnp.float32),
              classes=jnp.asarray(s.gt["classes"]),
              valid=jnp.asarray(s.gt["valid"]), probs=None)
    want = jax.jit(lambda v, x, hw, g: jpipe.oracle_train_losses(
        jmodel, v, x, hw, g, jnp.asarray(s.tokens), key, s.pcfg))(
        variables, jnormalize(jnp.asarray(s.images)), jnp.asarray(s.hw), gt)

    model = OpenVocabularyRCNN(num_classes=C, text_layers=1, text_width=32,
                               text_heads=2, box_reg_classes=C)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    rng_rpn, rng_roi = jax.random.split(key)
    anchors = (CANVAS[0] // 16) * (CANVAS[1] // 16) * 15
    pr = lambda k, n: torch.from_numpy(np.stack(
        [priorities(kk, n) for kk in jax.random.split(k, B)]))
    with torch.no_grad():
        got = tpipe.oracle_train_losses(
            model, normalize_batch(torch.from_numpy(s.images)),
            torch.from_numpy(s.hw), _port_gt(s.gt),
            torch.from_numpy(s.tokens).long(), pr(rng_rpn, anchors),
            pr(rng_roi, s.pcfg.post_nms_topk_train + G),
            dataclasses.replace(_port_cfg(s.pcfg),
                                cls_agnostic_bbox_reg=False))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=REL,
                                   atol=1e-6, err_msg=k)
    assert float(want["loss_box_reg"]) > 0


# ----------------------------------------------------- the CLI, end to end
@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The oracle through ``train_net.main`` with ``--device cpu`` on a
    synthetic VOC set (6 train, 4 val images), run once for the module:
    ORACLE/foggy.yaml for 3 steps (the trainable parameters recorded
    before the first), an eval with TEST.SAVE_DETECTION_PKLS and a
    checkpoint at step 3; ``--eval-only --resume``; then 2 steps with
    CLS_AGNOSTIC_BBOX_REG False, WarmupCosineLR and CLIP_GRADIENTS. The
    checkpoints (over 300 MB each with the full-width trunk) are deleted
    afterwards."""
    root = tmp_path_factory.mktemp("oracle")
    for split, n, seed in (("train", 6, 0), ("val", 4, 7)):
        tvoc.make_synthetic_voc(str(root / "synth/VOC2007"), num_images=n,
                                split=split, seed=seed)
    custom = [dict(NAME=f"osynth{s}", DIRNAME="synth/VOC2007", SPLIT=s,
                   CLASSES=list(CLASSES), EXT=".jpg")
              for s in ("train", "val")]
    tiny = ["DATASETS.ROOT", str(root), "DATASETS.CUSTOM", repr(custom),
            "DATASETS.TRAIN_UNLABEL", "['osynthtrain']",
            "DATASETS.TEST", "['osynthval']", "SOLVER.IMG_PER_BATCH_UNLABEL",
            "2", "SOLVER.WARMUP_ITERS", "2",
            "INPUT.MIN_SIZE_TRAIN", "64", "INPUT.MIN_SIZE_TEST", "64",
            "INPUT.MAX_SIZE", "96",
            "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64",
            "MODEL.RPN.PRE_NMS_TOPK_TEST", "64",
            "MODEL.RPN.POST_NMS_TOPK_TRAIN", "16",
            "MODEL.RPN.POST_NMS_TOPK_TEST", "16",
            "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "16",
            "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
            "TEST.DETECTIONS_PER_IMAGE", "8", "TPU.TEXT_LAYERS", "1",
            "TPU.TEXT_WIDTH", "32", "TPU.TEXT_HEADS", "2",
            "TPU.COMPUTE_DTYPE", "float32"]
    out = str(root / "out")
    cli = ["--config", ORACLE_YAML, "--device", "cpu"]
    shipped = [*tiny, "OUTPUT_DIR", out, "TEST.SAVE_DETECTION_PKLS", "True",
               "SOLVER.MAX_ITER", "3", "SOLVER.CHECKPOINT_PERIOD", "3",
               "TEST.EVAL_PERIOD", "3"]
    got = {}
    build = toracle.build_oracle_step

    def recording_build(*args, **kw):
        step = build(*args, **kw)

        def recorded(state, *a, **k):
            got.setdefault("before", _snapshot(state.model))
            got.setdefault("frozen", {
                n: p.detach().clone() for n, p in
                state.model.named_parameters() if not p.requires_grad})
            return step(state, *a, **k)
        return recorded

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(toracle, "build_oracle_step", recording_build)
        got["oracle"] = train_net.main(cli + shipped)
    got["records"] = tvoc.load_voc_instances(
        str(root / "synth/VOC2007"), "val", CLASSES, ".jpg")
    got["eval"] = train_net.main(cli + ["--eval-only", "--resume"] + shipped)
    got["per_class"] = train_net.main(cli + [*tiny,
        "OUTPUT_DIR", str(root / "per_class"), "SOLVER.MAX_ITER", "2",
        "MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG", "False",
        "SOLVER.LR_SCHEDULER_NAME", "WarmupCosineLR",
        "SOLVER.CLIP_GRADIENTS.ENABLED", "True"])
    got["out"] = out
    yield got
    for d in ("out/checkpoints", "out/code_snapshot", "per_class/checkpoints",
              "per_class/code_snapshot"):
        shutil.rmtree(root / d, ignore_errors=True)


def _metrics(out):
    with open(os.path.join(out, "metrics.json")) as f:
        return [json.loads(line) for line in f]


def test_oracle_cli_trains_evaluates_and_resumes(chain):
    """ORACLE/foggy.yaml through ``train_net.main``: an OracleTrainer
    three steps on, finite unweighted losses, trainable parameters that
    moved and frozen ones that did not; its eval at step 3 wrote
    ``detections.pckl``, which the port's ``evaluate_pkl`` reads back with
    the evaluator's AP50; the checkpoint at step 3 restores the whole
    state; ``--eval-only --resume`` gives the same AP."""
    tr = chain["oracle"]
    assert isinstance(tr, toracle.OracleTrainer) and tr.state.step == 3
    rows = _metrics(chain["out"])
    assert {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"} \
        <= set(rows[0])
    assert all(np.isfinite(v) for r in rows for k, v in r.items()
               if k.startswith("loss"))
    params = dict(tr.state.model.named_parameters())
    assert all(not torch.equal(chain["before"][n], params[n])
               for n in chain["before"] if n.startswith("res5."))
    assert any(n.startswith("backbone.layer1.") for n in chain["frozen"])
    assert all(torch.equal(p, params[n]) for n, p in chain["frozen"].items())
    ap = tr.ap_50[2]
    pkl = os.path.join(chain["out"], "detections.pckl")
    assert evaluate_pkl(pkl, chain["records"], CLASSES)["AP50"] == ap
    assert chain["eval"]["AP50"] == ap and 0.0 <= ap <= 100.0

    path = tr.checkpointer.latest_path()
    assert path.endswith("model_0000003")
    model = OpenVocabularyRCNN(num_classes=C, text_layers=1, text_width=32,
                               text_heads=2)
    fresh = toracle.init_oracle_state(tr.cfg, model, seed=1)
    tr.checkpointer.load(path, fresh)
    assert fresh.step == 3 and fresh.optimizer.count == 3
    want = tr.state.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in
               fresh.model.state_dict().items())
    wm = tr.state.optimizer.momentum_buffers()
    assert all(torch.equal(v, wm[k]) for k, v in
               fresh.optimizer.momentum_buffers().items())
    assert torch.equal(fresh.generator.get_state(),
                       tr.state.generator.get_state())
    assert fresh.prototypes is None


def test_oracle_cli_per_class_cosine_and_clip(chain):
    """Two steps with CLS_AGNOSTIC_BBOX_REG False (4 · C delta columns,
    one box loss on the offline classes, as JAX's oracle), WarmupCosineLR
    and CLIP_GRADIENTS: finite losses, the clip set, the schedule's rate
    logged at step 0."""
    tr = chain["per_class"]
    assert isinstance(tr, toracle.OracleTrainer) and tr.state.step == 2
    assert tr.model.box_predictor.bbox_pred.out_features == 4 * C
    assert tr.state.optimizer.clip_norm == 1.0
    rows = _metrics(tr.cfg.OUTPUT_DIR)
    assert all(np.isfinite(v) for r in rows for k, v in r.items()
               if k.startswith("loss"))
    assert rows[0]["lr"] == pytest.approx(
        tr.state.optimizer.schedule(0)) and rows[0]["loss_box_reg"] > 0
