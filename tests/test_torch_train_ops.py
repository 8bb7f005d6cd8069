"""Parity of the adaptation step's building blocks in coin_tpu_torch with
the JAX package's on the CPU: padded-set algebra, the matcher and the
balanced subsampler, dual-teacher matching, anchor labeling and the RPN
losses, proposal sampling and the ROI losses, the gradient discrepancy,
the CKG net, the prototype EMA, the LR schedule and one SGD update, and
RoIAlign's backward (K1b's plain version).

Random picks cannot be matched bit for bit, so every subsampling takes
JAX's own priorities, drawn from the key the JAX function splits.
Tolerances (f32): 1e-5 for the ops, the losses and the backward (the same
arithmetic summed in another order), 1e-4 for the CKG net and the losses
that go through it; masks, indices and labels are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coin_tpu.engine import matching as jmatching
from coin_tpu.engine import state as jstate
from coin_tpu.models import roi_heads as jrh
from coin_tpu.models import rpn as jrpn
from coin_tpu.models.anchors import grid_anchors
from coin_tpu.models.ckg import CKGNet as JCKGNet
from coin_tpu.ops import boxes as jboxes
from coin_tpu.ops import losses as jlosses
from coin_tpu.ops import matcher as jmatcher
from coin_tpu.ops import nms as jnms
from coin_tpu.ops import roi_align as jroi
from coin_tpu.solver import build as jsolver
from coin_tpu.structures import Detections as JDet
from coin_tpu.structures import truncate as jtruncate
from coin_tpu_torch import structures as tstruct
from coin_tpu_torch.config import load_config
from coin_tpu_torch.convert_from_jax import from_jax_variables
from coin_tpu_torch.engine import matching as tmatching
from coin_tpu_torch.engine import state as tstate
from coin_tpu_torch.models import roi_heads as trh
from coin_tpu_torch.models import rpn as trpn
from coin_tpu_torch.models.ckg import CKGNet
from coin_tpu_torch.ops import boxes as tboxes
from coin_tpu_torch.ops import losses as tlosses
from coin_tpu_torch.ops import matcher as tmatcher
from coin_tpu_torch.ops import nms as tnms
from coin_tpu_torch.ops import roi_align as troi
from coin_tpu_torch.solver import build as tsolver

TOL = dict(rtol=1e-5, atol=1e-5)
C = 3          # foreground classes


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def priorities(key, n):
    """The (pos, neg) uniform priorities ``subsample_labels`` draws from
    ``key``."""
    kp, kn = jax.random.split(key)
    return np.stack([np.asarray(jax.random.uniform(kp, (n,))),
                     np.asarray(jax.random.uniform(kn, (n,)))])


def random_boxes(rng, shape, size=120.0, min_wh=4.0, max_wh=60.0):
    xy = rng.uniform(0, size, shape + (2,))
    wh = rng.uniform(min_wh, max_wh, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def random_dets(rng, b, n, n_valid, with_probs=True):
    """Numpy fields of batched Detections with confident probs."""
    boxes = random_boxes(rng, (b, n))
    classes = rng.randint(0, C, (b, n)).astype(np.int32)
    probs = rng.dirichlet(np.full(C + 1, 0.5), (b, n)).astype(np.float32)
    probs[np.arange(b)[:, None], np.arange(n)[None], classes] += 1.0
    probs /= probs.sum(-1, keepdims=True)
    valid = np.zeros((b, n), bool)
    for i, k in enumerate(np.broadcast_to(n_valid, (b,))):
        valid[i, :k] = True
    classes[~valid] = -1
    return dict(boxes=boxes, scores=probs[..., :C].max(-1), classes=classes,
                valid=valid, probs=probs if with_probs else None)


def jdet(d, i=None):
    sel = (lambda a: a) if i is None else (lambda a: a[i])
    return JDet(**{k: None if v is None else jnp.asarray(sel(v))
                   for k, v in d.items()})


def tdet(d):
    return tstruct.Detections(**{k: None if v is None else _t(v)
                                 for k, v in d.items()})


def assert_dets(got, want, tol=TOL):
    for f in ("boxes", "scores", "probs"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            np.testing.assert_allclose(_np(g), _np(w), err_msg=f, **tol)
    np.testing.assert_array_equal(_np(got.valid), _np(want.valid))
    np.testing.assert_array_equal(_np(got.classes), _np(want.classes))


# ------------------------------------------------------ structures, boxes
def test_truncate_compacts_stably_like_jax(rng):
    d = random_dets(rng, 2, 12, 12)
    d["valid"] = rng.uniform(size=(2, 12)) < 0.5
    for cap in (4, 12):
        assert_dets(tstruct.truncate(tdet(d), cap), jtruncate(jdet(d), cap))


@pytest.mark.parametrize("fn", ["centers", "cxcywh_to_xyxy",
                                "xyxy_to_cxcywh"])
def test_box_helpers_match_jax(rng, fn):
    b = random_boxes(rng, (7,))
    np.testing.assert_allclose(getattr(tboxes, fn)(_t(b)).numpy(),
                               np.asarray(getattr(jboxes, fn)(b)), **TOL)


def test_weighted_box_fusion_pair_matches_jax(rng):
    a, b = random_boxes(rng, (9,)), random_boxes(rng, (9,))
    sa, sb = rng.uniform(size=(2, 9)).astype(np.float32)
    sa[0] = sb[0] = 0.0
    np.testing.assert_allclose(
        tnms.weighted_box_fusion_pair(*map(_t, (a, b, sa, sb))).numpy(),
        np.asarray(jnms.weighted_box_fusion_pair(a, b, sa, sb)), **TOL)


# -------------------------------------------------- matcher, subsampling
@pytest.mark.parametrize("low_quality", [False, True])
def test_match_matches_jax(rng, low_quality):
    gt = random_boxes(rng, (6,))
    pred = random_boxes(rng, (40,))
    pred[:6] = gt + 1.0                      # strong matches
    q = np.asarray(jboxes.pairwise_iou(gt, pred))
    gt_valid = np.array([1, 1, 0, 1, 1, 0], bool)
    for valid in (gt_valid, np.zeros(6, bool)):
        want = jmatcher.match(q, valid, (0.3, 0.7), (0, -1, 1), low_quality)
        got = tmatcher.match(_t(q), _t(valid), (0.3, 0.7), (0, -1, 1),
                             low_quality)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_subsample_labels_with_jax_priorities(rng):
    labels = rng.choice([-1, 0, 1], size=(3, 200), p=[0.2, 0.7, 0.1])
    labels[2, :] = 0                          # no positive at all
    keys = jax.random.split(jax.random.key(5), 3)
    pri = np.stack([priorities(k, 200) for k in keys])
    got = tmatcher.subsample_labels(_t(labels.astype(np.int8)), 64, 0.25,
                                    _t(pri[:, 0]), _t(pri[:, 1]))
    for i in range(3):
        want = jmatcher.subsample_labels(jnp.asarray(labels[i], jnp.int8),
                                         64, 0.25, keys[i])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


# ---------------------------------------------------- dual-teacher match
@pytest.mark.parametrize("case", ["general", "no_online", "no_offline"])
@pytest.mark.parametrize("box_a_weight", [1.0, 0.5])
def test_match_dual_teacher_matches_jax(rng, case, box_a_weight):
    online = random_dets(rng, 2, 10, [7, 4])
    offline = random_dets(rng, 2, 12, [9, 12])
    # pairs: some offline boxes on top of online ones, same or other class
    offline["boxes"][:, :5] = online["boxes"][:, :5] + rng.uniform(
        -2, 2, (2, 5, 4)).astype(np.float32)
    offline["classes"][:, :3] = online["classes"][:, :3]
    offline["boxes"][:, 5] = online["boxes"][:, 0]        # a duplicate
    offline["scores"][:, 6:9] = [0.9, 0.85, 0.5]          # degenerate A/C
    if case == "no_online":
        online["valid"][0] = False
    elif case == "no_offline":
        offline["valid"][1] = False
    for with_b in (True, False):
        got = tmatching.match_dual_teacher(tdet(online), tdet(offline), 0.5,
                                           box_a_weight, with_b=with_b)
        for i in range(2):
            want = jmatching.match_dual_teacher_single(
                jdet(online, i), jdet(offline, i), 0.5,
                jnp.asarray(box_a_weight), with_b=with_b)
            for g, w in zip(got, want):
                if isinstance(w, JDet):
                    assert_dets(g.map(lambda a: a[i]), w)
                else:
                    np.testing.assert_allclose(_np(g[i]), _np(w), **TOL)


# ------------------------------------------------------------------- RPN
@pytest.mark.parametrize("with_c", [True, False])
@pytest.mark.parametrize("any_a", [True, False])
def test_label_anchors_and_rpn_losses_match_jax(rng, with_c, any_a):
    anchors = np.asarray(grid_anchors(4, 8, 16))            # 480 anchors
    r = anchors.shape[0]
    gt_a = random_dets(rng, 2, 6, [4, 2] if any_a else 0)
    gt_c = random_dets(rng, 2, 5, [3, 5]) if with_c else None
    keys = jax.random.split(jax.random.key(3), 2)
    pri = np.stack([priorities(k, r) for k in keys])
    got = trpn.label_anchors(_t(anchors), tdet(gt_a),
                             None if gt_c is None else tdet(gt_c), _t(pri),
                             32, 0.5, (0.3, 0.7))
    want = [jrpn.label_anchors_single(
        jnp.asarray(anchors), jdet(gt_a, i),
        None if gt_c is None else jdet(gt_c, i), keys[i], 32, 0.5,
        (0.3, 0.7)) for i in range(2)]
    want = jrpn.RPNTargets(*[np.stack([np.asarray(getattr(w, f))
                                       for w in want])
                             for f in jrpn.RPNTargets._fields])
    for f in ("labels", "distill_labels"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f))
    for f in ("matched_boxes", "teacher_probs"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(want, f), **TOL)
    assert (got.labels == 1).any() or not any_a
    obj = rng.randn(2, r).astype(np.float32)
    deltas = (0.3 * rng.randn(2, r, 4)).astype(np.float32)
    for calc_bg in (True, False):
        w = jrpn.rpn_losses(jnp.asarray(anchors), obj, deltas,
                            jax.tree.map(jnp.asarray, want), 32,
                            calc_bg=calc_bg, with_distillation=with_c)
        g = trpn.rpn_losses(_t(anchors), _t(obj), _t(deltas), got, 32,
                            calc_bg=calc_bg, with_distillation=with_c)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(float(g[k]), float(w[k]),
                                       err_msg=k, **TOL)


# ------------------------------------------------------------- ROI heads
def _sampling_inputs(rng, b=2):
    props = random_dets(rng, b, 40, [40, 30], with_probs=False)
    props["classes"] = np.where(props["valid"], 0, -1).astype(np.int32)
    gt_a = random_dets(rng, b, 8, [5, 0])
    gt_b = random_dets(rng, b, 6, [2, 3])
    gt_c = random_dets(rng, b, 4, [2, 4])
    # proposals near the gt boxes so that every group is sampled
    props["boxes"][:, :8] = gt_a["boxes"] + 2.0
    props["boxes"][:, 8:14] = gt_b["boxes"] - 1.5
    props["boxes"][:, 14:18] = gt_c["boxes"] + 1.0
    b_cls_on = rng.randint(0, C, (b, 6)).astype(np.int32)
    b_probs_on = rng.dirichlet(np.ones(C + 1), (b, 6)).astype(np.float32)
    return props, gt_a, gt_b, gt_c, b_cls_on, b_probs_on


@pytest.mark.parametrize("bg_train", [True, False])
def test_sample_proposals_matches_jax(rng, bg_train):
    props, gt_a, gt_b, gt_c, b_cls_on, b_probs_on = _sampling_inputs(rng)
    n = 40 + 8 + 6
    keys = jax.random.split(jax.random.key(9), 2)
    pri = np.stack([priorities(k, n) for k in keys])
    got = trh.sample_proposals(
        tdet(props), tdet(gt_a), tdet(gt_b), tdet(gt_c), C, _t(pri), 24,
        0.25, 0.5, b_cls_online=_t(b_cls_on), b_probs_online=_t(b_probs_on),
        bg_train=bg_train)
    for i in range(2):
        want = jrh.sample_proposals_single(
            jdet(props, i), jdet(gt_a, i), jdet(gt_b, i), jdet(gt_c, i), C,
            keys[i], 24, 0.25, 0.5, b_cls_online=jnp.asarray(b_cls_on[i]),
            b_probs_online=jnp.asarray(b_probs_on[i]), bg_train=bg_train)
        for f, g, w in zip(jrh.SampledProposals._fields, got, want):
            np.testing.assert_allclose(_np(g[i]), _np(w), err_msg=f, **TOL)
    groups = set(got.group.flatten().tolist())
    assert {0, 1} <= groups and (2 in groups) == bg_train


def _sampled(rng, s=30):
    group = rng.choice([0, 1, 2, -1], s).astype(np.int8)
    cls = rng.randint(0, C, s).astype(np.int32)
    cls = np.where(group == 2, C, np.where(group == -1, -1, cls))
    return jrh.SampledProposals(
        boxes=random_boxes(rng, (s,)), group=group,
        gt_boxes=random_boxes(rng, (s,)), cls_offline=cls,
        cls_online=np.where(group == 1, (cls + 1) % C, cls).astype(np.int32),
        probs_offline=rng.dirichlet(np.ones(C + 1), s).astype(np.float32),
        probs_online=rng.dirichlet(np.ones(C + 1), s).astype(np.float32))


@pytest.mark.parametrize("loss", ["mil_ce", "mil_focal",
                                  "box_reg", "box_reg_offline", "kl_mean",
                                  "masked_mse", "kl_div", "masked_mean",
                                  "smooth_l1"])
def test_losses_match_jax(rng, loss):
    sp = _sampled(rng)
    tsp = trh.SampledProposals(*map(_t, sp))
    jsp = jrh.SampledProposals(*map(jnp.asarray, sp))
    scores = (3 * rng.randn(30, C + 1)).astype(np.float32)
    deltas = rng.randn(30, 4).astype(np.float32)
    q = rng.dirichlet(np.ones(C + 1), 30).astype(np.float32)
    valid = rng.uniform(size=30) < 0.6
    cw = np.asarray([1.0, 0.5, 2.0, 0.9], np.float32)
    if loss == "mil_ce":
        want = jrh.classification_loss(scores, jsp, C, 0.9)
        got = trh.classification_loss(_t(scores), tsp, C, 0.9)
    elif loss == "mil_focal":
        want = jrh.classification_loss(scores, jsp, C, 0.9, "MILFocalLoss",
                                       classes_weight=jnp.asarray(cw))
        got = trh.classification_loss(_t(scores), tsp, C, 0.9,
                                      "MILFocalLoss", classes_weight=_t(cw))
    elif loss.startswith("box_reg"):
        online = loss == "box_reg"
        want = jrh.box_reg_loss(jsp, deltas, C, online,
                                None if online else 7.0)
        got = trh.box_reg_loss(tsp, _t(deltas), C, online,
                               None if online else 7.0)
    elif loss == "kl_mean":
        logp = np.log(q[::-1] + 1e-7)
        want = jrh.kl_mean_elements(logp, q, valid)
        got = trh.kl_mean_elements(_t(logp), _t(q), _t(valid))
    elif loss == "masked_mse":
        want = jrh.masked_mse(q[::-1], q, valid)
        got = trh.masked_mse(_t(q[::-1]), _t(q), _t(valid))
    elif loss == "kl_div":
        logp = np.log(q[::-1] + 1e-7)
        want = jlosses.kl_div(logp, q, valid)
        got = tlosses.kl_div(_t(logp), _t(q), _t(valid))
    elif loss == "masked_mean":
        want = jlosses.masked_mean(deltas[:, 0], valid)
        got = tlosses.masked_mean(_t(deltas[:, 0]), _t(valid))
        assert float(tlosses.masked_mean(_t(deltas[:, 0]),
                                         _t(valid & False))) == 0.0
    else:
        want = jlosses.smooth_l1(deltas, deltas[::-1], beta=0.5)
        got = tlosses.smooth_l1(_t(deltas), _t(deltas[::-1]), beta=0.5)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_gradient_discrepancy_matches_jax(rng):
    """flax kernels are (in, out); the port's weights (out, in)."""
    shapes = [(12, 6), (6,), (6, 6), (6,)]
    ga = [rng.randn(*s).astype(np.float32) for s in shapes]
    gb = [rng.randn(*s).astype(np.float32) for s in shapes]
    gb[1] = np.zeros(6, np.float32)                 # a zero gradient
    want = jlosses.gradient_discrepancy(ga, gb)
    tr = lambda g: _t(g.T.copy() if g.ndim == 2 else g)
    got = tlosses.gradient_discrepancy([tr(g) for g in ga],
                                       [tr(g) for g in gb])
    np.testing.assert_allclose(float(got), float(want), **TOL)


# ------------------------------------------------------------- CKG, EMA
def test_ckg_net_matches_jax(rng):
    d, n = 64, 10
    jm = JCKGNet(hidden_size=d, num_classes=C + 1, head_num=8)
    args = [rng.randn(n, d), rng.randn(C + 1, d), rng.randn(C + 1, d),
            rng.dirichlet(np.ones(C + 1), n), rng.dirichlet(np.ones(C + 1), n)]
    args = [a.astype(np.float32) for a in args]
    variables = jm.init(jax.random.key(0), *args)
    tm = CKGNet(d, C + 1, 8)
    tm.load_state_dict(from_jax_variables(
        jax.tree.map(np.asarray, variables)), strict=True)
    want = jm.apply(variables, *args)
    with torch.no_grad():
        got = tm(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_prototype_ema_matches_jax(rng):
    cur = rng.randn(C + 1, 16).astype(np.float32)
    feats = rng.randn(20, 16).astype(np.float32)
    cls = rng.randint(0, C, 20)                      # class C never present
    oh = np.eye(C + 1, dtype=np.float32)[cls]
    valid = rng.uniform(size=20) < 0.7
    want = jstate.prototype_ema(cur, feats, oh, valid, 0.9)
    got = tstate.prototype_ema(*map(_t, (cur, feats, oh, valid)), 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_freeze_predicate_matches_jax():
    names = ["backbone/conv1/kernel", "backbone/layer1/0/conv1/kernel",
             "backbone/layer2/0/conv1/kernel", "backbone/layer3/5/conv3/kernel",
             "res5/layer4/0/conv2/kernel", "text_trunk/ln_final/scale",
             "prompted_text/embedding_tmp", "rpn_head/conv/bias",
             "box_predictor/trans_0/kernel"]
    for update, at in ((True, 2), (False, 2), (True, 1), (True, 4)):
        want = jstate.default_freeze_predicate(update, at)
        got = tstate.default_freeze_predicate(update, at)
        assert [got(n.replace("/", ".")) for n in names] \
            == [want(n) for n in names]


# ------------------------------------------------------ schedule, optimizer
def test_schedule_matches_jax():
    args = (0.01, [5, 8], [1, 0.1, 0.5], 4, 0.001)
    want = jsolver.two_stage_lr_schedule(*args)
    got = tsolver.two_stage_lr_schedule(*args)
    for step in range(12):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-7)


def test_sgd_update_matches_optax(rng):
    """Three updates of build_optimizer's chain on a small tree with a 0.1,
    a 0 and a 1 multiplier: momentum, weight decay and the schedule over
    the optimizer's own count."""
    cfg = load_config()
    cfg.SOLVER.BASE_LR = 0.1
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.STEPS = [2]
    cfg.SOLVER.FACTOR_LIST = [1, 0.5]
    cfg.SOLVER.WEIGHT_DECAY = 0.01
    overrides = {"backbone": 0.1, "frozen_by_lr": 0.0}
    params = {"backbone": {"w": rng.randn(4, 3).astype(np.float32)},
              "frozen_by_lr": {"b": rng.randn(3).astype(np.float32)},
              "head": {"w": rng.randn(3, 2).astype(np.float32)}}
    tx, _ = jsolver.build_optimizer(params, cfg, overrides=overrides)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {f"{a}.{b}": torch.nn.Parameter(_t(v)) for a, d in params.items()
          for b, v in d.items()}
    opt = tsolver.build_optimizer(tp.items(), cfg, overrides=overrides)
    for _ in range(3):
        grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32),
                             params)
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for a, d in grads.items():
            for b, g in d.items():
                tp[f"{a}.{b}"].grad = _t(g)
        opt.step()
    for a, d in jp.items():
        for b, v in d.items():
            np.testing.assert_allclose(tp[f"{a}.{b}"].detach().numpy(),
                                       np.asarray(v), rtol=1e-6, atol=1e-7)
    assert opt.count == 3


# ------------------------------------------------------- RoIAlign backward
@pytest.mark.parametrize("hw", [(13, 21), (21, 13)], ids=["w>=h", "w<h"])
def test_roi_align_backward_matches_jax_vjp(rng, hw):
    """The plain backward (K1b's plain version, through the autograd
    function) against jax.vjp of roi_align_batched, in f32; rois partly
    outside the map and past its far edge included."""
    h, w = hw
    feats = rng.randn(2, h, w, 8).astype(np.float32)
    rois = random_boxes(rng, (2, 9), size=16.0 * max(h, w), max_wh=200.0)
    rois[:, 0] = [-40.0, -30.0, 60.0, 50.0]
    rois[:, 1] = [16.0 * w - 30, 16.0 * h - 20, 16.0 * w + 90, 16.0 * h + 70]
    g = rng.randn(2, 9, 7, 7, 8).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jroi.roi_align_batched(
        f, jnp.asarray(rois), 1 / 16, 7, 2), jnp.asarray(feats))
    want, = vjp(jnp.asarray(g))
    f = _t(feats).requires_grad_(True)
    out = troi.roi_align_batched(f, _t(rois), 1 / 16, 7, 2)
    out.backward(_t(g))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        troi.roi_align_backward_plain(_t(g), _t(rois), feats.shape,
                                      torch.float32, 1 / 16, 7, 2).numpy(),
        np.asarray(want), **TOL)


@pytest.mark.parametrize("hw", [(13, 21), (21, 13)], ids=["w>=h", "w<h"])
def test_roi_align_bf16_rounds_once_within_two_ulps_of_jax(rng, monkeypatch,
                                                          hw):
    """bf16 RoIAlign, forward (K1's plain version) and backward (K1b's),
    against JAX's bf16 ``roi_align`` and its ``jax.vjp``, op by op. JAX
    rounds the (N, R, short, C) intermediate of each pass to bf16; the
    port rounds once, at the output. Measured over three seeds: 13-31 % of
    the outputs and 22-36 % of the feature gradients land on another bf16
    value, at most 0.61 % of the largest entry either way; held to 2**-7
    (two bf16 ulps) of it. JAX's bf16 einsums run on f32 copies of their
    operands (XLA's CPU runtime lacks some bf16 x bf16 -> f32 dots; exact
    products summed in f32 are their definition)."""
    einsum = jnp.einsum

    def exact_product_einsum(*args, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            args = [a.astype(jnp.float32) if getattr(a, "dtype", None)
                    == jnp.bfloat16 else a for a in args]
        return einsum(*args, preferred_element_type=preferred_element_type,
                      **kw)

    monkeypatch.setattr(jnp, "einsum", exact_product_einsum)
    h, w = hw
    bf16 = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(
        jnp.float32))
    feats = bf16(rng.randn(2, h, w, 16))
    rois = random_boxes(rng, (2, 9), size=16.0 * max(h, w), max_wh=200.0)
    g = bf16(rng.randn(2, 9, 14, 14, 16))
    with jax.disable_jit():
        out, vjp = jax.vjp(lambda f: jroi.roi_align_batched(
            f, jnp.asarray(rois), 1 / 16, 14, 2),
            jnp.asarray(feats, jnp.bfloat16))
        want_grad, = vjp(jnp.asarray(g, jnp.bfloat16))
    f = _t(feats).to(torch.bfloat16).requires_grad_(True)
    got = troi.roi_align_batched(f, _t(rois), 1 / 16, 14, 2)
    got.backward(_t(g).to(torch.bfloat16))
    for a, b in ((got.detach(), out), (f.grad, want_grad)):
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        assert np.abs(a - b).max() <= 2.0 ** -7 * np.abs(b).max()


@pytest.mark.parametrize("which", ["roi_align_bwd", "augment"])
def test_new_cuda_launchers_refuse_cpu_tensors(which):
    """K1b's and K4's launchers never fall back: a CPU tensor is refused
    before any build or launch."""
    from coin_tpu_torch.kernels.augment import augment_cuda
    from coin_tpu_torch.kernels.roi_align import roi_align_backward_cuda
    call = {
        "roi_align_bwd": lambda: roi_align_backward_cuda(
            torch.zeros(1, 2, 7, 7, 8), torch.zeros(1, 2, 4), (1, 4, 4, 8),
            torch.float32, 1.0, 7, 2),
        "augment": lambda: augment_cuda(
            torch.zeros(1, 2, 2, 3, dtype=torch.uint8), torch.zeros(1, 20),
            (0.5,) * 3, (0.25,) * 3),
    }[which]
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_f32_master_weights_compute_like_stored_bf16_weights(rng):
    """Parameters stay f32 and are cast to the compute dtype at each call:
    the same bits as weights stored in bf16, while an update smaller than
    half a bf16 ulp still moves the f32 master."""
    import copy
    from coin_tpu_torch.models.detector import OpenVocabularyRCNN
    from coin_tpu_torch.models.layers import Conv2d
    model = OpenVocabularyRCNN(num_classes=C, text_layers=1, text_width=32,
                               text_heads=2,
                               compute_dtype=torch.bfloat16).random_init(0)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    stored = copy.deepcopy(model)
    for m in stored.modules():
        if isinstance(m, Conv2d):
            m.to(torch.bfloat16)
    images = _t(rng.randn(1, 32, 64, 3).astype(np.float32))
    with torch.no_grad():
        got, want = model.features(images), stored.features(images)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    # an update of 1e-4 of each weight: below half a bf16 ulp (2^-9
    # relative), so a bf16-stored weight rounds back; the f32 master moves
    w = model.res5.layer4[0].conv1.weight.detach()
    w16 = w.to(torch.bfloat16)
    assert torch.equal(w16 + 1e-4 * w16, w16)
    assert not torch.equal(w + 1e-4 * w, w)
