"""The detector-inference slice as a whole against the JAX package on the
CPU: ``pipelines.inference`` and ``evaluate_detector`` of both packages on
one set of weights (the tiny f32 detector of test_torch_models), and the
teacher's fast head (``TPU.TEACHER_FAST_HEAD``): ``pool_boxes_fast`` (res5
over the whole res4 map, then RoIAlign of the res5 map at stride 32,
resolution 7, then the mean pool) at the modules' 1e-4 in f32 and at a
measured bound in bf16, and the fast-head branch of ``inference``.

Top-k and NMS are discrete: on near-tied random-init scores they may flip
between XLA and PyTorch. So the stage test feeds both sides the same
tensors at each discrete stage (proposal prediction, box inference) and
requires identical kept indices, while the continuous stages are compared
numerically (rtol = atol = 1e-4, as the modules).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coin_tpu.data.augment import normalize_batch as jnormalize
from coin_tpu.engine import pipelines as jpipe
from coin_tpu.models import roi_heads as jrh
from coin_tpu.models import rpn as jrpn
from coin_tpu_torch.convert_from_jax import from_jax_variables
from coin_tpu_torch.data.augment import normalize_batch
from coin_tpu_torch.engine import pipelines as tpipe
from coin_tpu_torch.models import roi_heads as trh
from coin_tpu_torch.models import rpn as trpn
from coin_tpu_torch.models.detector import OpenVocabularyRCNN
from coin_tpu_torch.structures import Detections
from tests.test_torch_models import CANVAS, random_rois, tiny_pair
from tests.test_torch_models import two_torch_threads  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def _tcfg(pcfg) -> tpipe.PipelineConfig:
    return tpipe.PipelineConfig(
        num_classes=pcfg.num_classes, rpn_nms_thresh=pcfg.rpn_nms_thresh,
        pre_nms_topk_test=pcfg.pre_nms_topk_test,
        post_nms_topk_test=pcfg.post_nms_topk_test,
        pooler_resolution=pcfg.pooler_resolution,
        test_score_thresh=pcfg.test_score_thresh,
        test_nms_thresh=pcfg.test_nms_thresh, test_topk=pcfg.test_topk)


def _inputs(seed=1):
    """Blocky images (16 px cells of one colour): crops then differ, and
    so do the rows' scores, which keeps near ties out of the top-k."""
    rng = np.random.RandomState(seed)
    cells = rng.randint(0, 256, (2, CANVAS[0] // 16, CANVAS[1] // 16, 3))
    images = cells.repeat(16, 1).repeat(16, 2).astype(np.uint8)
    hw = np.asarray([CANVAS, (CANVAS[0], 100)], np.float32)
    return images, hw


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_dets_equal(got, want, box_tol=1e-5):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=box_tol, atol=box_tol)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=box_tol, atol=box_tol)
    if want.probs is not None:
        np.testing.assert_allclose(got.probs.numpy(),
                                   np.asarray(want.probs),
                                   rtol=box_tol, atol=box_tol)


def test_inference_stages_match_jax(pair):
    jmodel, pcfg, tokens, variables, tmodel = pair
    cfg = _tcfg(pcfg)
    images_u8, hw = _inputs()
    apply = lambda m, *a: jmodel.apply(variables, *a, method=m)

    images = jnormalize(jnp.asarray(images_u8))
    feats = apply("features", images)
    obj, deltas = apply("rpn", feats)
    anchors = jpipe._anchors_for(images, pcfg)
    with torch.no_grad():
        t_feats = tmodel.features(normalize_batch(_t(images_u8)))
        t_obj, t_deltas = tmodel.rpn(t_feats)
    np.testing.assert_allclose(t_feats.numpy(), np.asarray(feats), **TOL)
    np.testing.assert_allclose(t_obj.numpy(), np.asarray(obj), **TOL)
    np.testing.assert_allclose(t_deltas.numpy(), np.asarray(deltas), **TOL)

    # discrete: identical logits and deltas on both sides
    props = jrpn.predict_proposals(anchors, obj, deltas, jnp.asarray(hw),
                                   pcfg.pre_nms_topk_test,
                                   pcfg.post_nms_topk_test,
                                   pcfg.rpn_nms_thresh)
    t_props = trpn.predict_proposals(_t(anchors), _t(obj), _t(deltas),
                                     _t(hw), cfg.pre_nms_topk_test,
                                     cfg.post_nms_topk_test,
                                     cfg.rpn_nms_thresh)
    _assert_dets_equal(t_props, props)

    pooled = apply("pool_boxes", feats, props.boxes, pcfg.pooler_resolution)
    text = apply("text_features", tokens)
    scores, box_deltas, _ = apply("predict", pooled, text)
    with torch.no_grad():
        t_pooled = tmodel.pool_boxes(_t(feats), _t(props.boxes))
        t_text = tmodel.text_features(_t(tokens).long())
        t_scores, t_box_deltas, _ = tmodel.predict(_t(pooled), _t(text))
    np.testing.assert_allclose(t_pooled.numpy(), np.asarray(pooled), **TOL)
    np.testing.assert_allclose(t_text.numpy(), np.asarray(text), **TOL)
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(scores), **TOL)
    np.testing.assert_allclose(t_box_deltas.numpy(), np.asarray(box_deltas),
                               **TOL)

    # discrete: identical probabilities and boxes on both sides
    probs = jax.nn.softmax(scores, axis=-1)
    from coin_tpu.ops import boxes as jboxes
    boxes = jboxes.decode_deltas(props.boxes, box_deltas, jrh.BOX_REG_WEIGHTS)
    dets = jax.vmap(lambda b, p, v, h: jrh.fast_rcnn_inference_single(
        b, p, v, h, pcfg.test_score_thresh, pcfg.test_nms_thresh,
        pcfg.test_topk))(boxes, probs, props.valid, jnp.asarray(hw))
    t_dets = trh.fast_rcnn_inference(_t(boxes), _t(probs), _t(props.valid),
                                     _t(hw), cfg.test_score_thresh,
                                     cfg.test_nms_thresh, cfg.test_topk)
    _assert_dets_equal(t_dets, dets)
    assert int(t_dets.valid.sum()) > 0


@pytest.mark.parametrize("rows,classes", [(400, 8), (50, 3)],
                         ids=["cut-to-1024", "no-cut"])
def test_fast_rcnn_inference_matches_jax(rng, rows, classes):
    """Box inference on identical inputs, with and without the
    pre_nms_candidates=1024 cut; tied probabilities and invalid rows
    included."""
    probs = rng.dirichlet(np.full(classes + 1, 0.3), (2, rows))
    probs = (np.round(probs * 20) / 20).astype(np.float32)    # ties
    xy = rng.uniform(0, 150, (2, rows, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (2, rows, 2))], -1)
    boxes = boxes.astype(np.float32)
    valid = rng.uniform(size=(2, rows)) < 0.9
    hw = np.asarray([[160, 200], [120, 180]], np.float32)
    want = jax.vmap(lambda b, p, v, h: jrh.fast_rcnn_inference_single(
        b, p, v, h, 0.05, 0.5, 100))(*map(jnp.asarray,
                                          (boxes, probs, valid, hw)))
    got = trh.fast_rcnn_inference(*map(_t, (boxes, probs, valid, hw)),
                                  0.05, 0.5, 100)
    _assert_dets_equal(got, want)
    assert int(got.valid.sum()) > 0


def test_inference_end_to_end_matches_jax(pair):
    """The whole test branch of both packages on the same images. The
    random-init classifier scores its rows within ~1e-4 of each other, so
    the order of near-tied detections may differ: with the top-k cut
    lifted, each image's detections are compared as a set."""
    jmodel, pcfg, tokens, variables, tmodel = pair
    pcfg = dataclasses.replace(pcfg, test_topk=1024)
    images_u8, hw = _inputs(seed=2)
    want = jax.jit(lambda v, im, h: jpipe.inference(
        jmodel, v, jnormalize(im), h, tokens, pcfg))(
            variables, jnp.asarray(images_u8), jnp.asarray(hw))
    with torch.no_grad():
        got = tpipe.inference(tmodel, normalize_batch(_t(images_u8)), _t(hw),
                              _t(tokens).long(), _tcfg(pcfg))
    for i in range(2):
        g = _as_rows(got.boxes[i].numpy(), got.classes[i].numpy(),
                     got.scores[i].numpy(), got.valid[i].numpy())
        w = _as_rows(*(np.asarray(a[i]) for a in (
            want.boxes, want.classes, want.scores, want.valid)))
        assert len(g) > 0
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)


# bf16 eval (foggy_fast.yaml computes in bf16): measured on these inputs,
# each image's share of JAX's detections paired with one of the port's
# (same class, every coordinate within PAIR_PX) 0.685 and 0.767, the score
# deltas of the pairs at most 2.6e-3 and their box deltas at most 0.18 px.
# JAX's own bf16 and f32 detections pair as loosely (0.72 and 0.66, score
# deltas 2.9e-3, box deltas 0.15 px): the random-init classifier scores its
# rows within ~1e-4 of each other, so bf16 rounding re-ranks them and NMS
# keeps other boxes.
PAIR_PX = 2.0
BF16_SHARE, BF16_SCORE, BF16_BOX = 0.6, 5e-3, 0.5


def _paired(got, want):
    """(share of ``want``'s rows paired, max score delta, max box delta):
    each row of ``want`` takes the nearest free row of ``got`` of its class
    whose coordinates all lie within PAIR_PX."""
    free = list(range(len(got)))
    ds, db = [0.0], [0.0]
    for w in want:
        near = [(np.abs(got[j, 1:5] - w[1:5]).max(), j) for j in free
                if got[j, 0] == w[0]]
        d, j = min(near, default=(np.inf, -1))
        if d <= PAIR_PX:
            free.remove(j)
            ds.append(abs(got[j, 5] - w[5]))
            db.append(d)
    return (len(ds) - 1) / len(want), max(ds), max(db)


def test_inference_end_to_end_bf16_matches_jax_bf16(pair):
    """The test branch of both packages in bf16 (f32 weights cast per
    call, as foggy_fast.yaml runs) on the same images, the top-k cut
    lifted; held to the measured pairing above."""
    jmodel, pcfg, tokens, variables, tmodel = pair
    pcfg = dataclasses.replace(pcfg, test_topk=1024)
    jbf16 = jmodel.clone(compute_dtype=jnp.bfloat16)
    tbf16 = OpenVocabularyRCNN(num_classes=tmodel.num_classes, text_layers=2,
                               text_width=64, text_heads=2,
                               compute_dtype=torch.bfloat16).eval()
    tbf16.load_state_dict(from_jax_variables(variables), strict=True)
    images_u8, hw = _inputs(seed=2)
    want = jax.jit(lambda v, im, h: jpipe.inference(
        jbf16, v, jnormalize(im), h, tokens, pcfg))(
            variables, jnp.asarray(images_u8), jnp.asarray(hw))
    with torch.no_grad():
        got = tpipe.inference(tbf16, normalize_batch(_t(images_u8)), _t(hw),
                              _t(tokens).long(), _tcfg(pcfg))
    for i in range(2):
        g = _as_rows(got.boxes[i].numpy(), got.classes[i].numpy(),
                     got.scores[i].numpy(), got.valid[i].numpy())
        w = _as_rows(*(np.asarray(a[i]) for a in (
            want.boxes, want.classes, want.scores, want.valid)))
        share, dscore, dbox = _paired(g, w)
        print(f"bf16 image {i}: {share:.3f} paired, score {dscore:.3g}, "
              f"box {dbox:.3g} px")
        assert share >= BF16_SHARE
        assert dscore <= BF16_SCORE and dbox <= BF16_BOX


def _as_rows(boxes, classes, scores, valid):
    """Valid detections as (class, box, score) rows in a canonical order."""
    rows = np.concatenate([classes[valid, None].astype(np.float64),
                           boxes[valid], scores[valid, None]], 1)
    return rows[np.lexsort(np.round(rows[:, :5], 2).T[::-1])]


def test_evaluate_detector_ap_matches_jax(pair, tmp_path):
    """evaluate_detector of both packages on a 6-image synthetic VOC set:
    the same AP, AP50 and AP75."""
    from coin_tpu.data.loader import TestLoader as JLoader
    from coin_tpu.data.voc import register_pascal_voc as jregister
    from coin_tpu.engine.evaluator import evaluate_detector as jevaluate
    from coin_tpu_torch.data.loader import TestLoader
    from coin_tpu_torch.data.voc import make_synthetic_voc, register_pascal_voc
    from coin_tpu_torch.engine.evaluator import evaluate_detector

    jmodel, pcfg, tokens, variables, tmodel = pair
    classes = ("car", "person", "truck")
    make_synthetic_voc(str(tmp_path / "voc"), num_images=6,
                       class_names=classes, image_hw=CANVAS, seed=3,
                       split="val")
    for register in (jregister, register_pascal_voc):
        register("torch_parity_val", "voc", "val", classes, ".jpg")
    kw = dict(batch_size=4, min_size=CANVAS[0], max_size=CANVAS[1])
    want = jevaluate(jmodel, variables,
                     JLoader("torch_parity_val", str(tmp_path), **kw),
                     np.asarray(tokens), pcfg)
    loader = TestLoader("torch_parity_val", str(tmp_path), **kw)
    assert loader.canvas_hw == CANVAS
    got = evaluate_detector(tmodel, tmodel.state_dict(), loader,
                            np.asarray(tokens), _tcfg(pcfg))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


# ------------------------------------------------------------ fast head
# bf16 (each package's convolutions in bf16 over f32 weights): measured on
# these inputs, the port's pooled features lie at most 0.0078 from JAX's,
# against a largest |value| of 0.99 (res5's three blocks round at every
# convolution, in another order on each side); the bound is 2.5 times that
FAST_BF16_ATOL = 0.02


def _pool_inputs(rng):
    feats = rng.randn(2, 4, 8, 1024).astype(np.float32)
    # RoIs from below a res5 cell to past the 64 x 128 canvas
    return feats, random_rois(rng, 2, 6)


def test_pool_boxes_fast_matches_jax(pair, rng):
    jmodel, _, _, variables, tmodel = pair
    feats, rois = _pool_inputs(rng)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(feats),
                                   jnp.asarray(rois),
                                   method="pool_boxes_fast"))
    with torch.no_grad():
        got = tmodel.pool_boxes_fast(torch.from_numpy(feats),
                                     torch.from_numpy(rois)).numpy()
    assert got.shape == (2, 6, 2048)
    np.testing.assert_allclose(got, want, **TOL)


def test_pool_boxes_fast_bf16_matches_jax_bf16(pair, rng):
    jmodel, _, _, variables, tmodel = pair
    feats, rois = _pool_inputs(rng)
    jbf16 = jmodel.clone(compute_dtype=jnp.bfloat16)
    want = np.asarray(jbf16.apply(
        variables, jnp.asarray(feats, jnp.bfloat16), jnp.asarray(rois),
        method="pool_boxes_fast").astype(jnp.float32))
    tbf16 = OpenVocabularyRCNN(num_classes=tmodel.num_classes, text_layers=2,
                               text_width=64, text_heads=2,
                               compute_dtype=torch.bfloat16).eval()
    tbf16.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = tbf16.pool_boxes_fast(
            torch.from_numpy(feats).bfloat16(),
            torch.from_numpy(rois)).float().numpy()
    err = np.abs(got - want).max()
    print(f"bf16 pool_boxes_fast: max abs err {err:.4g}, max |want| "
          f"{np.abs(want).max():.3g}")
    assert err <= FAST_BF16_ATOL


# the random-init classifier scores the rows of a cluster of boxes within
# ~1e-4 of each other, so the class-wise NMS keeps other members of such a
# cluster on each side: measured on these inputs, all 92 of JAX's rows of
# image 0 and 93 of its 96 rows of image 1 (93 of the port's 95; the rest
# are class-0 boxes scoring 0.115) pair with a row of the other side
# within 1e-4
FAST_PAIRED_SHARE = 0.95


def test_fast_head_inference_matches_jax(pair, monkeypatch):
    """The test branch with ``fast_head`` in both packages on the same
    images and proposals, the top-k cut lifted. The stages before the fast
    head (features, RPN) are held at 1e-4 by test_torch_inference; here
    both packages' inference runs from JAX's res4 features and proposals
    (the RPN's top-k and NMS see near-tied random-init logits). The fast
    head's pooled features and the predictor's scores and deltas inside
    the port's inference are held to JAX's at 1e-4, and its detections
    pair with JAX's (same class, box and score within 1e-4) as stated
    above."""
    jmodel, pcfg, tokens, variables, tmodel = pair
    pcfg = dataclasses.replace(pcfg, test_topk=1024, fast_head=True)
    images_u8, hw = _inputs(seed=2)
    rpn_forward = jpipe.rpn_forward

    def jax_side(v, im, h):
        """JAX's features and proposals, its fast head's pooled features
        and predictions on them, and its inference from those proposals."""
        im = jnormalize(im)
        feats = jmodel.apply(v, im, method="features")
        rpn = rpn_forward(jmodel, v, feats, h, jpipe._anchors_for(im, pcfg),
                          pcfg, False)
        pooled = jmodel.apply(v, feats, rpn[2].boxes,
                              method="pool_boxes_fast")
        text = jmodel.apply(v, tokens, method="text_features")
        scores, deltas, _ = jmodel.apply(v, pooled, text, method="predict")
        monkeypatch.setattr(jpipe, "rpn_forward", lambda *a, **k: rpn)
        dets = jpipe.inference(jmodel, v, im, h, tokens, pcfg)
        monkeypatch.setattr(jpipe, "rpn_forward", rpn_forward)
        return feats, rpn[2], (pooled, scores, deltas), dets
    feats, props, stages, want = jax.jit(jax_side)(
        variables, jnp.asarray(images_u8), jnp.asarray(hw))
    t_props = Detections(_t(props.boxes), _t(props.scores),
                         _t(props.classes), _t(props.valid))
    monkeypatch.setattr(tmodel, "features", lambda images: _t(feats))
    monkeypatch.setattr(tpipe, "rpn_forward",
                        lambda *a, **k: (None, None, t_props))
    seen = []
    for name in ("pool_boxes_fast", "predict"):
        fn = getattr(tmodel, name)
        monkeypatch.setattr(tmodel, name, lambda *a, fn=fn: seen.append(
            fn(*a)) or seen[-1])
    tcfg = dataclasses.replace(_tcfg(pcfg), fast_head=True)
    with torch.no_grad():
        got = tpipe.inference(tmodel, normalize_batch(_t(images_u8)), _t(hw),
                              _t(tokens).long(), tcfg)
    assert len(seen) == 2            # the fast head, then the predictor
    pooled, (scores, deltas, _) = seen
    for g, w in zip((pooled, scores, deltas), stages):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for i in range(2):
        g = _as_rows(got.boxes[i].numpy(), got.classes[i].numpy(),
                     got.scores[i].numpy(), got.valid[i].numpy())
        w = _as_rows(*(np.asarray(a[i]) for a in (
            want.boxes, want.classes, want.scores, want.valid)))
        assert len(g) > 0
        for a, b in ((g, w), (w, g)):
            near = [np.abs(a[(a[:, 0] == r[0])] - r).max(1)
                    .min(initial=np.inf) <= 1e-4 for r in b]
            print(f"image {i}: {sum(near)} of {len(b)} rows paired")
            assert sum(near) >= FAST_PAIRED_SHARE * len(b)
