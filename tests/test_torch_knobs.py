"""The knobs of ROADMAP item 8c that the oracle's modules reach, in
coin_tpu_torch against the JAX package on the CPU: per-class box
regression (``MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG: false``), the
LR schedulers ``WarmupMultiStepLR`` and ``WarmupCosineLR``,
``SOLVER.CLIP_GRADIENTS``, the detection pickles of
``TEST.SAVE_DETECTION_PKLS`` (``evaluation/dump``), and RN101's parameter
tree (``configs/coin/ORACLE/clipart.yaml``).

Tolerances: the per-class loss and inference ops 1e-5 (f32 in another
order; indices, classes and masks equal); the adaptation step's two box
losses 1e-5 of JAX's ``box_reg_loss`` on the step's own sampled rows and
deltas; ``WarmupMultiStepLR`` bit for bit; ``WarmupCosineLR`` within 2 ulp
of BASE_LR at every step (compiled JAX folds π / decay into one constant,
so its angle differs from the source's order by an ulp, which 1 + cos
carries into the rate); 5 clipped SGD updates 1e-6 relative (the global
norm summed in another order); pickles equal; the APs of the swapped
pickles equal to the last bit.
"""

import os
import pickle
from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coin_tpu.evaluation import dump as jdump
from coin_tpu.evaluation.voc_eval import VOCEvaluator as JVOCEvaluator
from coin_tpu.models import roi_heads as jrh
from coin_tpu.models.detector import OpenVocabularyRCNN as JRCNN
from coin_tpu.ops import boxes as jboxes
from coin_tpu.solver import build as jsolver
from coin_tpu_torch.config import load_config
from coin_tpu_torch.convert_from_jax import from_jax_variables
from coin_tpu_torch.engine import coin_pipelines as tcp
from coin_tpu_torch.engine import pipelines as tpipe
from coin_tpu_torch.engine.common import simple_class_tokens
from coin_tpu_torch.engine.matching import match_dual_teacher
from coin_tpu_torch.evaluation import dump as tdump
from coin_tpu_torch.evaluation.voc_eval import VOCEvaluator
from coin_tpu_torch.models import roi_heads as trh
from coin_tpu_torch.models.detector import OpenVocabularyRCNN
from coin_tpu_torch.solver import build as tsolver
from coin_tpu_torch.structures import Detections
from tests.test_torch_models import two_torch_threads  # noqa: F401
from tests.test_torch_train_ops import _np, _sampled, _t, random_boxes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE_YAML = os.path.join(REPO, "configs/coin/ORACLE/foggy.yaml")
C = 3
TOL = dict(rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ schedules
@pytest.mark.parametrize("name,warmup,max_iter,base_lr", [
    ("WarmupMultiStepLR", 3, 20, 0.02), ("WarmupCosineLR", 5, 23, 0.02),
    ("WarmupCosineLR", 0, 10, 0.001), ("WarmupCosineLR", 400, 40000, 0.001)],
    ids=["multistep", "cosine", "cosine-no_warmup", "cosine-oracle"])
def test_schedule_matches_jax(name, warmup, max_iter, base_lr):
    """Every step of the schedule (every 37th of the oracle's 40 000), and
    a few past its end, against JAX's ``make_schedule`` jitted as the
    optimizer calls it (an int32 count)."""
    cfg = load_config(ORACLE_YAML, [
        "SOLVER.LR_SCHEDULER_NAME", name, "SOLVER.WARMUP_ITERS",
        str(warmup), "SOLVER.MAX_ITER", str(max_iter), "SOLVER.STEPS",
        "[4, 9]", "SOLVER.GAMMA", "0.3", "SOLVER.BASE_LR", str(base_lr)])
    want_fn = jax.jit(jsolver.make_schedule(cfg.SOLVER))
    got_fn = tsolver.make_schedule(cfg.SOLVER)
    steps = range(0, max_iter + 3, 37 if max_iter > 100 else 1)
    want = np.asarray([want_fn(jnp.int32(i)) for i in steps], np.float32)
    got = np.asarray([got_fn(i) for i in steps], np.float32)
    if name == "WarmupMultiStepLR":
        np.testing.assert_array_equal(got, want)
        assert len(set(got[3:].tolist())) == 3
        return
    ulp = np.spacing(np.float32(base_lr))
    assert np.abs(got - want).max() <= 2 * ulp
    # the warmup starts near BASE_LR · WARMUP_FACTOR (optax's f32 sum
    # rounds it), the cosine at BASE_LR and ends at 0
    assert got_fn(0) == pytest.approx(base_lr * (0.001 if warmup else 1),
                                      rel=1e-3)
    assert np.float32(got_fn(warmup)) == np.float32(base_lr)
    assert got_fn(max_iter) == 0.0


# ------------------------------------------------------- gradient clip
@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no_clip"])
def test_clipped_sgd_matches_jax_chain(clip):
    """5 updates of ``ScheduledSGD`` from ``build_optimizer`` against the
    JAX package's optax chain, with CLIP_GRADIENTS on and off, on a tree
    with a multiplier of 0 (its gradient counts in the global norm) and a
    parameter without a gradient (a zero one, also counted). The norms
    over the 5 steps straddle the clip value, so some steps clip and
    others do not."""
    cfg = load_config(ORACLE_YAML, [
        "SOLVER.BASE_LR", "0.1", "SOLVER.WARMUP_ITERS", "2",
        "SOLVER.WEIGHT_DECAY", "0.01", "SOLVER.CLIP_GRADIENTS.ENABLED",
        str(clip), "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "1.5",
        "SOLVER.PER_MODULE_PARAM_WEIGHT", "[{'frozen_head': 0.0}]"])
    rng = np.random.RandomState(3)
    shapes = {"conv": {"kernel": (3, 4)}, "frozen_head": {"bias": (5,)},
              "unused": {"scale": (2, 2)}}
    params = {k: {n: rng.randn(*s).astype(np.float32) for n, s in v.items()}
              for k, v in shapes.items()}
    scales = [0.2, 1.6, 0.4, 2.5, 0.9]
    grads = [{k: {n: (sc * rng.randn(*s)).astype(np.float32) if k != "unused"
                  else np.zeros(s, np.float32) for n, s in v.items()}
              for k, v in shapes.items()} for sc in scales]
    norms = [np.sqrt(sum(float((x ** 2).sum()) for d in g.values()
                         for x in d.values())) for g in grads]
    assert min(norms) < 1.5 < max(norms)

    tx, _ = jsolver.build_optimizer(params, cfg)
    update = jax.jit(tx.update)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    named = [(f"{k}.{n}", torch.nn.Parameter(torch.from_numpy(a.copy())))
             for k, v in params.items() for n, a in v.items()]
    opt = tsolver.build_optimizer(named, cfg)
    assert opt.multipliers["frozen_head.bias"] == 0.0
    assert opt.clip_norm == (1.5 if clip else None)
    for g in grads:
        updates, opt_state = update(jax.tree.map(jnp.asarray, g),
                                    opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        for name, p in named:
            k, n = name.split(".")
            if k != "unused":
                p.grad = torch.from_numpy(g[k][n].copy())
        opt.step()
        for name, p in named:
            k, n = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k][n]),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
    assert opt.count == 5


# ------------------------------------------------- per-class regression
@pytest.mark.parametrize("online", [True, False], ids=["online", "offline"])
def test_box_reg_loss_per_class_matches_jax(rng, online):
    """(S, 4 · C) deltas: each fg row's own (online or offline) class picks
    its column; the B rows, whose two classes differ, set the two losses
    apart."""
    sp = _sampled(rng)
    deltas = rng.randn(30, 4 * C).astype(np.float32)
    want = jrh.box_reg_loss(jrh.SampledProposals(*map(jnp.asarray, sp)),
                            jnp.asarray(deltas), C, use_online_classes=online)
    got = trh.box_reg_loss(trh.SampledProposals(*map(_t, sp)), _t(deltas),
                           C, use_online_classes=online)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    other = trh.box_reg_loss(trh.SampledProposals(*map(_t, sp)), _t(deltas),
                             C, use_online_classes=not online)
    assert float(other) != float(got)


def _predictor_pair(rng, box_reg_classes, d=64):
    """The JAX and the port's box predictor of a detector with
    ``box_reg_classes`` columns of 4, sharing one set of weights."""
    jmodel = JRCNN(num_classes=C, box_reg_classes=box_reg_classes)
    bp = {"trans_0": (d, d // 2), "trans_1": (d // 2, d // 2),
          "trans_2": (d // 2, d), "cls_score": (d, 1024),
          "bbox_pred": (d, 4 * box_reg_classes)}
    params = {k: {"kernel": (rng.randn(*s) / np.sqrt(s[0])).astype(
        np.float32), "bias": (0.1 * rng.randn(s[1])).astype(np.float32)}
        for k, s in bp.items()}
    params["bbox_pred"]["kernel"] *= 3.0
    tmodel = trh.BoxPredictor(d, 1024, box_dim=4 * box_reg_classes)
    tmodel.load_state_dict(from_jax_variables(params))
    return jmodel, {"params": {"box_predictor": params}}, tmodel


def test_box_inference_per_class_matches_jax(rng):
    """``pipelines.box_inference`` with a per-class predictor: (R, C)
    candidate boxes decoded from each proposal, the 1024-candidate cut
    (R · C = 1200), class-aware NMS and the top-k, against the JAX
    package's inference tail (``engine/pipelines.inference`` after the
    pool) on the same pooled features and proposals."""
    b, r, d = 2, 400, 64
    jmodel, jvars, tpred = _predictor_pair(rng, C)
    tmodel = torch.nn.Module()
    tmodel.box_predictor = tpred
    tmodel.box_reg_classes = C
    tmodel.predict = lambda pooled, text: OpenVocabularyRCNN.predict(
        tmodel, pooled, text)
    pooled = rng.randn(b, r, d).astype(np.float32)
    text = rng.randn(C + 1, 1024).astype(np.float32)
    boxes = random_boxes(rng, (b, r), size=90.0, max_wh=40.0)
    valid = np.arange(r)[None] < np.asarray([[r], [r - 37]])
    hw = np.asarray([[64, 128], [64, 100]], np.float32)
    pcfg = tpipe.PipelineConfig(num_classes=C, test_score_thresh=0.01,
                                test_topk=50)

    def jax_tail(pooled, text, boxes, valid, hw):
        scores, deltas, _ = jmodel.apply(jvars, pooled, text,
                                         method="predict")
        probs = jax.nn.softmax(scores, axis=-1)
        per_cls = deltas.reshape(deltas.shape[:-1] + (-1, 4))
        cand = jboxes.decode_deltas(boxes[..., None, :], per_cls,
                                    jrh.BOX_REG_WEIGHTS)
        return jax.vmap(lambda bx, pr, v, h: jrh.fast_rcnn_inference_single(
            bx, pr, v, h, 0.01, 0.5, 50))(cand, probs, valid, hw)
    want = jax.jit(jax_tail)(pooled, text, boxes, valid, hw)
    props = Detections(boxes=_t(boxes), scores=torch.ones(b, r),
                       classes=torch.zeros(b, r, dtype=torch.int32),
                       valid=_t(valid))
    with torch.no_grad():
        got = tpipe.box_inference(tmodel, _t(pooled), props, _t(hw),
                                  _t(text), pcfg)
    np.testing.assert_array_equal(_np(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(_np(got.classes), np.asarray(want.classes))
    assert int(want.valid.sum()) > 40
    for f in ("boxes", "scores", "probs"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f)


def test_fast_rcnn_inference_per_class_boxes_match_jax(rng):
    """``fast_rcnn_inference`` on (B, R, C, 4) per-class boxes (clipped to
    each image, the (row, class) candidates row-major, each its own box)
    against jitted ``fast_rcnn_inference_single``."""
    b, r = 2, 300
    boxes = random_boxes(rng, (b, r, C), size=110.0, max_wh=50.0) - 5.0
    scores = rng.dirichlet(np.full(C + 1, 0.3), (b, r)).astype(np.float32)
    valid = rng.rand(b, r) < 0.9
    hw = np.asarray([[64, 128], [80, 96]], np.float32)
    want = jax.jit(jax.vmap(lambda bx, s, v, h:
                            jrh.fast_rcnn_inference_single(
                                bx, s, v, h, 0.05, 0.5, 60)))(
        boxes, scores, valid, hw)
    got = trh.fast_rcnn_inference(_t(boxes), _t(scores), _t(valid), _t(hw),
                                  0.05, 0.5, 60)
    np.testing.assert_array_equal(_np(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(_np(got.classes), np.asarray(want.classes))
    for f in ("boxes", "scores", "probs"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f)


def test_adaptation_step_per_class_losses_match_jax_box_reg():
    """``student_forward`` of a per-class detector (the adaptation step's
    forward, ``CLS_AGNOSTIC_BBOX_REG: false``): ``loss_box_reg_online`` and
    ``loss_box_reg_offline`` and no ``loss_box_reg``, each equal to JAX's
    ``box_reg_loss`` on the step's own sampled rows and (R, 4 · C) deltas
    with the step's shared normalizer; the two differ, since B rows were
    sampled."""
    gen = torch.Generator().manual_seed(4)
    model = OpenVocabularyRCNN(num_classes=C, text_layers=1, text_width=32,
                               text_heads=2, box_reg_classes=C).random_init(1)
    assert model.box_predictor.bbox_pred.out_features == 4 * C
    recorded = {}
    predict = model.predict

    def recording_predict(pooled, text):
        recorded["out"] = predict(pooled, text)
        return recorded["out"]
    model.predict = recording_predict
    b, hh, ww, n = 2, 64, 96, 6
    boxes = torch.cat([torch.rand(b, n, 2, generator=gen) * 40,
                       torch.zeros(b, n, 2)], -1)
    boxes[..., 2:] = boxes[..., :2] + 16 + torch.rand(b, n, 2,
                                                      generator=gen) * 30
    probs = torch.softmax(3 * torch.randn(b, n, C + 1, generator=gen), -1)
    online = Detections(boxes=boxes, scores=probs[..., :C].amax(-1),
                        classes=probs[..., :C].argmax(-1).int(),
                        valid=torch.ones(b, n, dtype=torch.bool), probs=probs)
    # the offline view: the same boxes, jittered, half of them relabelled
    shift = (torch.arange(n) % 2).int()
    offline = online.replace(boxes=boxes + 1.0,
                             classes=(online.classes + shift) % C,
                             probs=probs.roll(1, -1))
    rcnn = match_dual_teacher(online, offline, 0.5, 1.0, with_b=True)
    rpn = match_dual_teacher(online, offline, 0.5, 1.0, with_b=False)
    pcfg = tpipe.PipelineConfig(
        num_classes=C, pre_nms_topk_train=64, post_nms_topk_train=16,
        roi_batch_size=32, rpn_batch_size=16, cls_agnostic_bbox_reg=False)
    cand = pcfg.post_nms_topk_train + 3 * n
    images = torch.randn(b, hh, ww, 3, generator=gen)
    tokens = torch.from_numpy(simple_class_tokens(C + 1)).long()
    with torch.no_grad():
        fw = tcp.student_forward(
            model, images, torch.tensor([[64.0, 96.0], [64.0, 80.0]]), rcnn,
            rpn, tokens, torch.rand(b, 2, 4 * 6 * 15, generator=gen),
            torch.rand(b, 2, cand, generator=gen), pcfg, False,
            model.text_features(tokens), None)
    assert "loss_box_reg" not in fw.losses
    deltas = recorded["out"][1][:, :fw.sp.boxes.shape[0] // b]
    deltas = deltas.reshape(-1, 4 * C).numpy()
    sp = jrh.SampledProposals(*(jnp.asarray(_np(x)) for x in fw.sp))
    assert int((sp.group == jrh.GROUP_B).sum()) > 0
    bg = bool((sp.group == jrh.GROUP_BG).any())
    denom = (float(max(int((sp.group != jrh.GROUP_PAD).sum()), 1)) if bg
             else float(pcfg.roi_batch_size * b))
    for name, use_online in (("loss_box_reg_online", True),
                             ("loss_box_reg_offline", False)):
        want = jrh.box_reg_loss(sp, jnp.asarray(deltas), C,
                                use_online_classes=use_online,
                                normalizer=denom)
        np.testing.assert_allclose(float(fw.losses[name]), float(want),
                                   **TOL, err_msg=name)
    assert float(fw.losses["loss_box_reg_online"]) != \
        float(fw.losses["loss_box_reg_offline"])
    weights = tpipe.loss_weights_from(load_config(ORACLE_YAML))
    assert {"loss_box_reg_online", "loss_box_reg_offline"} <= set(weights)


def test_build_detector_maps_cls_agnostic_knob():
    """``build_detector`` gives 4 delta columns under the shipped
    CLS_AGNOSTIC_BBOX_REG and 4 · C without it, as the JAX base maps the
    knob to ``box_reg_classes``."""
    for agnostic, cols in ((True, 4), (False, 4 * C)):
        cfg = load_config(ORACLE_YAML, [
            "MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG", str(agnostic),
            "TPU.TEXT_LAYERS", "1", "TPU.TEXT_WIDTH", "32",
            "TPU.TEXT_HEADS", "2"])
        model = tpipe.build_detector(cfg, C, "cpu")
        assert model.box_predictor.bbox_pred.out_features == cols
        assert tpipe.pipeline_config_from(cfg, C).cls_agnostic_bbox_reg \
            == agnostic


# -------------------------------------------------------------- pickles
def _evaluators(rng, classes):
    """The JAX package's and the port's VOCEvaluator fed the same four
    images (boxes in original-image coordinates, two classes)."""
    ev = (JVOCEvaluator(classes), VOCEvaluator(classes))
    records = []
    for i in range(4):
        gt = random_boxes(rng, (5,), size=200.0, max_wh=80.0)
        gcls = rng.randint(0, len(classes), 5)
        pred = np.concatenate([gt[:3] + rng.randn(3, 4).astype(np.float32),
                               random_boxes(rng, (4,), size=200.0)])
        pcls = np.concatenate([gcls[:3], rng.randint(0, len(classes), 4)])
        scores = rng.rand(7).astype(np.float32)
        diff = np.zeros(5, bool)
        for e in ev:
            e.process(f"img{i}", pred, scores, pcls, gt, gcls, diff)
        records.append(dict(image_id=f"img{i}", boxes=gt, classes=gcls,
                            difficult=diff))
    return ev, records


def test_detection_pickles_match_jax_and_swap(rng, tmp_path):
    """The port's ``detections.pckl`` equals the JAX package's for the
    same evaluator input (the reference's +1 coordinates), and each
    package's ``evaluate_pkl`` reads the other's with the same AP as the
    evaluator's own."""
    classes = ("car", "person")
    (jev, tev), records = _evaluators(rng, classes)
    jpath = jdump.save_detections_pkl(jev, str(tmp_path / "jax.pckl"))
    tpath = tdump.save_detections_pkl(tev, str(tmp_path / "sub/port.pckl"))
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        want, got = pickle.load(f), pickle.load(g)
    assert got == want and set(got) == set(classes)
    assert got["car"]["img0"][0][1:] == pytest.approx(
        (tev._dets["car"]["img0"][0][1]).tolist())
    ap = tev.evaluate()
    assert ap == jev.evaluate() and 0 < ap["AP50"] < 100
    for path in (jpath, tpath):
        assert tdump.evaluate_pkl(path, records, classes) == \
            jdump.evaluate_pkl(path, records, classes) == ap


def test_evaluator_writes_detections_pckl(rng, tmp_path, monkeypatch):
    """TEST.SAVE_DETECTION_PKLS makes ``DetectorTrainerBase.evaluate``
    hand ``OUTPUT_DIR/detections.pckl`` to ``evaluate_detector``, as the
    JAX base does; off, no path."""
    from coin_tpu_torch.engine import base
    seen = []
    monkeypatch.setattr(base, "evaluate_detector",
                        lambda *a, save_pkl=None: seen.append(save_pkl))
    tr = base.DetectorTrainerBase.__new__(base.DetectorTrainerBase)
    tr._eval_loader = object()
    tr.class_tokens = tr.pcfg = None
    model = torch.nn.Linear(1, 1)
    for on in (True, False):
        tr.cfg = load_config(ORACLE_YAML, [
            "TEST.SAVE_DETECTION_PKLS", str(on), "OUTPUT_DIR",
            str(tmp_path)])
        tr.evaluate(model)
    assert seen == [str(tmp_path / "detections.pckl"), None]


# ---------------------------------------------------------------- RN101
def _leaf_shapes(tree):
    """{port name: shape} of a JAX parameter tree of ShapeDtypeStructs,
    each leaf carried by ``from_jax_variables`` on its own (a zero-stride
    array, so nothing of the model's size is allocated at once)."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            one = leaf = {}
            for p in path:
                leaf = leaf.setdefault(p, {})
            leaf[k] = np.broadcast_to(np.float32(0), v.shape)
            (name, t), = from_jax_variables(one).items()
            out[name] = tuple(t.shape)

    walk(tree["params"], ())
    return out


def test_rn101_tree_maps_onto_port():
    """clipart.yaml's detector (RN101: layer3 of 23 blocks, text dim 512,
    20 classes, the full text tower): JAX's init by ``jax.eval_shape``
    (nothing computed) maps leaf for leaf onto the port's state dict (built
    on the meta device), shape for shape."""
    cfg = load_config(os.path.join(REPO, "configs/coin/ORACLE/clipart.yaml"))
    assert cfg.MODEL.RESNETS.DEPTH == 101
    nc = 20
    jmodel = JRCNN(num_classes=nc, depth=101)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
        jnp.asarray(simple_class_tokens(nc + 1)), jnp.zeros((1, 1, 4)))
    want = _leaf_shapes(shapes)
    with torch.device("meta"):
        tmodel = tpipe.build_detector(cfg, nc, "meta")
    got = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert got == want
    assert sum(k.startswith("backbone.layer3.") and k.endswith("conv1.weight")
               for k in got) == 23
    assert got["box_predictor.cls_score.weight"] == (512, 2048)
