"""The port's Grounding DINO teacher against the JAX package's on the CPU:
Swin (K9's plain version), deformable attention (K7's), BERT, the GDINO
layers and the whole model, post-processing, the fusion NMS (K6's), and
the official-checkpoint map. The same numpy inputs and one set of
weights go through both packages (``convert_from_jax.load_jax_params``,
or each package's own checkpoint map).

Tolerances, f32: outputs agree to 1e-4 of their largest magnitude (the
same arithmetic, summed in another order; LayerNorm's variance as
E[x²] - E[x]² in flax, two-pass in torch); the fusion NMS gives the same
rows and classes, boxes, scores and probs to 1e-5; captions, masks and
key sets are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coin_tpu.models import deformable as jdef
from coin_tpu.models import gdino as jg
from coin_tpu.models import gdino_detector as jgd
from coin_tpu.models import manifests as jman
from coin_tpu.models import swin as jswin
from coin_tpu.models.convert_gdino import (bert_params_from_checkpoint,
                                           convert_gdino as jconvert)
from coin_tpu.models.wordpiece import WordPieceTokenizer as JTok
from coin_tpu.ops import nms as jnms
from coin_tpu.structures import Detections as JDet
from coin_tpu_torch.convert_from_jax import load_jax_params
from coin_tpu_torch.models import deformable as tdef
from coin_tpu_torch.models import gdino as tg
from coin_tpu_torch.models import gdino_detector as tgd
from coin_tpu_torch.models import manifests as tman
from coin_tpu_torch.models import swin as tswin
from coin_tpu_torch.models.bert import BertModel
from coin_tpu_torch.models.convert_gdino import (bert_state_dict,
                                                 convert_gdino as tconvert)
from coin_tpu_torch.models.wordpiece import WordPieceTokenizer as TTok
from coin_tpu_torch.ops import nms as tnms
from coin_tpu_torch.structures import Detections as TDet

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads beside the suite's other pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), \
        (err, np.abs(want).max())


def random_params(jmodule, rng, *args):
    """A parameter tree of the JAX module's shapes (``jax.eval_shape`` of
    its init, no forward run), drawn from ``rng``: kernels at 1/sqrt(fan
    in) (flax zero-inits the deformable offsets), norm scales near 1,
    biases and tables at small random values."""
    dyn = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]

    def init(key, *arrays):
        full = list(args)
        for i, a in zip(dyn, arrays):
            full[i] = a
        return jmodule.init(key, *full)
    shapes = jax.eval_shape(init, jax.random.key(0),
                            *[jnp.asarray(args[i]) for i in dyn])["params"]

    def fill(path, s):
        name, shape = path[-1].key, s.shape
        x = rng.randn(*shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * x
        if name in ("bias", "embedding"):
            return 0.1 * x
        return 0.5 * x
    return jax.tree_util.tree_map_with_path(fill, shapes)


def loaded(tmodule, params):
    load_jax_params(tmodule, params)
    return tmodule


def run_pair(jmodule, params, tmodule, *args):
    """JAX's apply (jitted; ints, lists and None are static) and the
    port's forward on the same numpy inputs."""
    dyn = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]

    def japply(p, *arrays):
        full = list(args)
        for i, a in zip(dyn, arrays):
            full[i] = a
        return jmodule.apply({"params": p}, *full)
    jout = jax.jit(japply)(params, *[jnp.asarray(args[i]) for i in dyn])
    with torch.no_grad():
        tout = tmodule(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                         else a for a in args])
    return jout, tout


# ------------------------------------------------------------------ Swin
@pytest.mark.parametrize("dim,heads,win,shift,hw", [
    (96, 3, 7, 0, (14, 21)), (64, 2, 12, 6, (24, 36))],
    ids=["w7", "w12_shift6"])
def test_window_attention_and_swin_block_match_jax(rng, dim, heads, win,
                                                   shift, hw):
    h, w = hw
    x = rng.randn(2, h * w, dim).astype(np.float32)
    jb = jswin.SwinBlock(dim, heads, win, shift)
    p = random_params(jb, rng, x, h, w)
    tb = loaded(tswin.SwinBlock(dim, heads, win, shift), p)
    want, got = run_pair(jb, p, tb, x, h, w)
    close(got, want)
    # the attention alone, on the windows with their shift mask
    xw = rng.randn(2 * (h // win) * (w // win), win * win,
                   dim).astype(np.float32)
    mask = jswin._attn_mask(h, w, win, shift) if shift else None
    if shift:
        np.testing.assert_array_equal(tswin._attn_mask(h, w, win, shift),
                                      mask)
    np.testing.assert_array_equal(tswin._rel_pos_index(win),
                                  jswin._rel_pos_index(win))
    want, got = run_pair(jswin.WindowAttention(dim, heads, win), p["attn"],
                         tb.attn, xw, mask)
    close(got, want)


def test_patch_merging_odd_sizes_matches_jax(rng):
    x = rng.randn(2, 7 * 9, 32).astype(np.float32)
    jm = jswin.PatchMerging(32)
    p = random_params(jm, rng, x, 7, 9)
    want, got = run_pair(jm, p, loaded(tswin.PatchMerging(32), p), x, 7, 9)
    assert got.shape == (2, 4 * 5, 64)
    close(got, want)


def test_swin_tiny_backbone_matches_jax(rng):
    images = rng.randn(2, 64, 96, 3).astype(np.float32)
    jm = jswin.SwinTransformer("swinT")
    p = random_params(jm, rng, images)
    want, got = run_pair(jm, p, loaded(tswin.SwinTransformer("swinT"), p),
                         images)
    assert [tuple(g.shape) for g in got] == [(2, 8, 12, 192), (2, 4, 6, 384),
                                             (2, 2, 3, 768)]
    for g, w in zip(got, want):
        close(g, w)


# ------------------------------------------------------------ deformable
SHAPES = [(6, 8), (3, 4), (2, 2), (1, 1)]
STARTS = [0, 48, 60, 64]


def test_ms_deform_sample_matches_jax_with_points_outside(rng):
    values = rng.randn(2, 65, 4, 8).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (2, 11, 4, 4, 3, 2)).astype(np.float32)
    loc[0, 0, 0, 0, 0] = [0.0, 1.0]                   # on the edges
    weights = rng.uniform(0, 1, (2, 11, 4, 4, 3)).astype(np.float32)
    want = jdef.ms_deform_sample(jnp.asarray(values), SHAPES, STARTS,
                                 jnp.asarray(loc), jnp.asarray(weights))
    got = tdef.ms_deform_sample(torch.from_numpy(values), SHAPES, STARTS,
                                torch.from_numpy(loc),
                                torch.from_numpy(weights))
    close(got, want, 1e-5)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_ms_deform_attention_matches_jax(rng, ref_dim):
    query = rng.randn(2, 9, 256).astype(np.float32)
    value = rng.randn(2, 65, 256).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (2, 9, 4, ref_dim)).astype(np.float32)
    jm = jdef.MSDeformAttention()
    p = random_params(jm, rng, query, ref, value, SHAPES, STARTS)
    want, got = run_pair(jm, p, loaded(tdef.MSDeformAttention(), p), query,
                         ref, value, SHAPES, STARTS)
    close(got, want)


# ------------------------------------------------------------------ BERT
def test_bert_matches_flax_bert_with_padding(rng):
    transformers = pytest.importorskip("transformers")
    from coin_tpu_torch.models.bert import BertConfig
    config = transformers.BertConfig(vocab_size=40, hidden_size=768,
                                     num_hidden_layers=2,
                                     num_attention_heads=12,
                                     intermediate_size=3072)
    jbert = transformers.FlaxBertModel(config, _do_init=False)
    ids = rng.randint(0, 40, (2, 9))
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False
    p = random_params(jbert.module, rng, ids, mask)
    want = jax.jit(lambda p, i, m: jbert.module.apply({"params": p}, i, m)[
        0])(p, jnp.asarray(ids), jnp.asarray(mask))
    tbert = loaded(BertModel(BertConfig(vocab_size=40, num_hidden_layers=2)),
                   p)
    with torch.no_grad():
        got = tbert(torch.from_numpy(ids), torch.from_numpy(mask))
    close(got, want)


# --------------------------------------------------------- GDINO layers
def _layer_case(name, rng):
    vis = rng.randn(2, 65, 256).astype(np.float32)
    lang = rng.randn(2, 7, 256).astype(np.float32)
    lmask = np.ones((2, 7), bool)
    lmask[1, 5:] = False
    smask = rng.uniform(size=(2, 1, 7, 7)) > 0.3
    smask[:, :, np.arange(7), np.arange(7)] = True
    ref2 = rng.uniform(0.05, 0.95, (2, 65, 4, 2)).astype(np.float32)
    tgt = rng.randn(2, 9, 256).astype(np.float32)
    qpos = rng.randn(2, 9, 256).astype(np.float32)
    ref4 = rng.uniform(0.1, 0.6, (2, 9, 4, 4)).astype(np.float32)
    return {
        "MHA": (jg.MHA(256, 8), tg.MHA(256, 8), (tgt, vis, vis, None)),
        "MHA_masked": (jg.MHA(256, 4), tg.MHA(256, 4),
                       (lang, lang, lang, smask)),
        "BiMultiHeadAttention": (jg.BiMultiHeadAttention(),
                                 tg.BiMultiHeadAttention(),
                                 (vis, lang, lmask)),
        "FusionLayer": (jg.FusionLayer(), tg.FusionLayer(),
                        (vis, lang, lmask)),
        "TextSelfAttnLayer": (jg.TextSelfAttnLayer(), tg.TextSelfAttnLayer(),
                              (lang, smask)),
        "ImageEncoderLayer": (jg.ImageEncoderLayer(), tg.ImageEncoderLayer(),
                              (vis, vis * 0.5, ref2, SHAPES, STARTS)),
        "DecoderLayer": (jg.DecoderLayer(), tg.DecoderLayer(),
                         (tgt, qpos, vis, lang, lmask, ref4, SHAPES,
                          STARTS)),
    }[name]


@pytest.mark.parametrize("name", ["MHA", "MHA_masked",
                                  "BiMultiHeadAttention", "FusionLayer",
                                  "TextSelfAttnLayer", "ImageEncoderLayer",
                                  "DecoderLayer"])
def test_gdino_layer_matches_jax(rng, name):
    jm, tm, args = _layer_case(name, rng)
    p = random_params(jm, rng, *args)
    want, got = run_pair(jm, p, loaded(tm, p), *args)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        close(g, w)


@pytest.fixture(scope="module")
def tiny_gdino():
    """swinT, 16 queries, one encoder and one decoder layer, 64 × 96, as
    tests/test_collect_integration.py builds it."""
    rng = np.random.RandomState(5)
    images = rng.randn(2, 64, 96, 3).astype(np.float32)
    embeds = rng.randn(2, 7, 768).astype(np.float32)
    tmask = np.ones((2, 7), bool)
    tmask[1, 6] = False
    smask = np.broadcast_to(np.eye(7, dtype=bool) | (rng.uniform(
        size=(7, 7)) > 0.4), (2, 1, 7, 7)).copy()
    jm = jg.GroundingDINO(variant="swinT", num_queries=16, enc_layers=1,
                          dec_layers=1)
    p = random_params(jm, rng, images[:1], embeds[:1], tmask[:1])
    tm = loaded(tg.GroundingDINO(variant="swinT", num_queries=16,
                                 enc_layers=1, dec_layers=1), p)
    args = (images, embeds, tmask, smask)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
        p, *map(jnp.asarray, args))
    return tm, args, jax.device_get(want)


def test_grounding_dino_matches_jax(tiny_gdino):
    tm, args, (jlogits, jboxes) = tiny_gdino
    with torch.no_grad():
        logits, boxes = tm(*map(torch.from_numpy, args))
    finite = np.isfinite(jlogits)
    np.testing.assert_array_equal(torch.isfinite(logits).numpy(), finite)
    assert not finite[1, :, 6].any() and finite[0].all()
    close(logits.numpy()[finite], jlogits[finite])
    close(boxes, jboxes)


def test_grounding_dino_stages_compose(tiny_gdino):
    """backbone → project → enhance → select_queries → decode is the
    forward, and the extra level is 3×3 stride 2 with XLA's padding."""
    tm, args, _ = tiny_gdino
    images, embeds, tmask, smask = map(torch.from_numpy, args)
    with torch.no_grad():
        feats = tm.backbone(images)
        src, pos, shapes, starts = tm.project(feats)
        assert shapes == [(8, 12), (4, 6), (2, 3), (1, 2)]
        assert starts == [0, 96, 120, 126] and src.shape == (2, 128, 256)
        src, lang = tm.enhance(src, pos, shapes, starts, embeds, tmask,
                               smask)
        ref = tm.select_queries(src, lang, tmask, shapes)
        staged = tm.decode(src, lang, tmask, ref, shapes, starts)
        whole = tm(images, embeds, tmask, smask)
    for a, b in zip(staged, whole):
        assert torch.equal(a, b)
    x = torch.zeros(1, 19, 38, 4)
    assert tg.same_pad_stride2(x).shape == (1, 21, 39, 4)   # (1,1), (0,1)


# ------------------------------------------------------ post-processing
@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("bert") / "vocab.txt"
    path.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", ".",
                               "car", "person", "traffic", "light",
                               "##s"]) + "\n")
    return str(path)


def test_captions_masks_and_tokenizer_match_jax(vocab_path):
    names = ["car", "traffic_light", "persons", "bicycle"]
    jt, tt = JTok(vocab_path), TTok(vocab_path)
    jcap, jids, jspans = jgd.build_captions_and_spans(names, jt)
    tcap, tids, tspans = tgd.build_captions_and_spans(names, tt)
    assert tcap == jcap and tspans == jspans
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(
        tgd.positive_map_from_spans(tspans, len(tids)),
        jgd.positive_map_from_spans(jspans, len(jids)))
    np.testing.assert_array_equal(
        tgd.phrase_self_attention_mask(tids, tt.encode("."),
                                       [tt.cls, tt.sep]),
        jgd.phrase_self_attention_mask(jids, jt.encode("."),
                                       [jt.cls, jt.sep]))
    assert tt("a car . persons", 12) == jt("a car . persons", 12)


@pytest.mark.parametrize("type_filter,capacity", [
    (False, 20), (False, 8), (True, 12)])
def test_postprocess_gdino_matches_jax(rng, type_filter, capacity):
    nq, t = 20, 9
    logits = rng.randn(2, nq, t).astype(np.float32) * 2
    logits[:, :, 7:] = -np.inf                       # masked tokens
    logits[0, 3] = logits[0, 4]                      # tied queries
    boxes = rng.uniform(0.1, 0.6, (2, nq, 4)).astype(np.float32)
    pm = tgd.positive_map_from_spans([(1, 3), (4, 5), (5, 7)], t)
    hw = np.asarray([[64.0, 96.0], [60.0, 80.0]], np.float32)
    want = jax.vmap(lambda lg, bx, h: jgd.postprocess_gdino(
        lg, bx, jnp.asarray(pm), h, 0.4, capacity, type_filter))(
            jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(hw))
    got = tgd.postprocess_gdino(torch.from_numpy(logits),
                                torch.from_numpy(boxes),
                                torch.from_numpy(pm), torch.from_numpy(hw),
                                0.4, capacity, type_filter)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    assert 0 < int(got.valid.sum())
    assert not bool(got.valid.all()) or capacity < 20
    for f in ("boxes", "scores", "probs"):
        close(getattr(got, f), getattr(want, f), 1e-6)


# ------------------------------------------------------------ fusion NMS
def _fusion_inputs(rng, n=48, c1=4, b=2):
    centres = rng.uniform(20, 200, (b, 5, 2))
    pick = rng.randint(0, 5, (b, n))
    xy = np.take_along_axis(centres, pick[..., None], 1) \
        + rng.uniform(-6, 6, (b, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(20, 40, (b, n, 2))],
                           -1).astype(np.float32)
    probs = rng.dirichlet(np.ones(c1), (b, n)).astype(np.float32)
    probs[:, 6:10] = probs[:, :1]                      # exact ties
    boxes[:, 6:10] = boxes[:, :1]
    classes = probs[..., :-1].argmax(-1).astype(np.int32)
    classes[:, 20:30] = rng.randint(0, c1 - 1, (b, 10))  # across classes
    valid = rng.uniform(size=(b, n)) > 0.2
    classes[~valid] = -1
    return boxes, probs, classes, valid


@pytest.mark.parametrize("score_method", ["probEn", "avg", "max"])
@pytest.mark.parametrize("box_method", ["s-avg", "avg", "max"])
def test_fusion_nms_matches_jax(rng, score_method, box_method):
    boxes, probs, classes, valid = _fusion_inputs(rng)
    scores = probs[..., :-1].max(-1)
    want = jax.vmap(lambda b, s, c, v, p: jnms.fusion_nms(
        JDet(b, s, c, v, p), 0.5, score_method, box_method))(
            *map(jnp.asarray, (boxes, scores, classes, valid, probs)))
    got = tnms.fusion_nms(TDet(*map(torch.from_numpy, (
        boxes, scores, classes, valid, probs))), 0.5, score_method,
        box_method)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    for f in ("boxes", "scores", "probs"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    n_valid = int(got.valid.sum())
    assert 0 < n_valid < int(valid.sum())   # clusters fused, some merged


def test_merge_probs_match_jax(rng):
    a = rng.dirichlet(np.ones(5), (3, 7)).astype(np.float32)
    b = rng.dirichlet(np.ones(5), (3, 7)).astype(np.float32)
    a[0, 0] = 0.0                                     # the 1e-20 floor
    b[1, 1] = a[1, 1]                                 # a tie
    for jf, tf in ((jnms.merge_probs_bayesian, tnms.merge_probs_bayesian),
                   (jnms.merge_probs_max, tnms.merge_probs_max)):
        for w, g in zip(jf(jnp.asarray(a), jnp.asarray(b)),
                        tf(torch.from_numpy(a), torch.from_numpy(b))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


# -------------------------------------------------- official checkpoint
def _norms_at_one(sd, rng):
    """synth_state_dict draws every tensor N(0, 0.02²); norms near 1 keep
    the activations away from zero (and the query scores apart)."""
    for k, v in sd.items():
        if v.ndim == 1 and k.endswith(".weight") and (
                "norm" in k or "LayerNorm" in k or ".1.weight" in k):
            sd[k] = (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
    return sd


@pytest.mark.parametrize("variant", ["swinB", "swinT"])
def test_manifests_match_jax(variant):
    assert tman.gdino_manifest(variant) == jman.gdino_manifest(variant)
    assert tman.swin_manifest(variant) == jman.swin_manifest(variant)
    assert tman.bert_manifest() == jman.bert_manifest()
    keys, _ = tman.gdino_manifest("swinT", 1, 1, 16, 2, bert_vocab=8)
    a, b = tman.synth_state_dict(keys, 3), jman.synth_state_dict(keys, 3)
    assert all(np.array_equal(a[k], b[k]) for k in keys)
    assert tman.diff_keys(list(keys)[1:] + ["x"], keys, set()) == \
        jman.diff_keys(list(keys)[1:] + ["x"], keys, set())


def test_checkpoint_map_matches_jax_convert(rng):
    """One reduced official-layout checkpoint (swinT, 1/1 layers, 16
    queries, 2 BERT layers) through each package's own map: the models
    and the BERTs agree."""
    keys, _ = tman.gdino_manifest("swinT", 1, 1, 16, 2, bert_vocab=40)
    sd = _norms_at_one(tman.synth_state_dict(keys, seed=7), rng)
    sd["module.feat_map.weight"] = sd.pop("feat_map.weight")  # DataParallel
    jparams = jconvert(dict(sd), "swinT", enc_layers=1, dec_layers=1)
    jbert, jbert_params = bert_params_from_checkpoint(
        {k: torch.from_numpy(v) for k, v in sd.items()})
    tm = tg.GroundingDINO("swinT", 16, 1, 1)
    tm.load_state_dict(tconvert(sd, "swinT", 1, 1), strict=True)
    bcfg, bsd = bert_state_dict(sd)
    tbert = BertModel(bcfg)
    tbert.load_state_dict(bsd, strict=True)

    ids = rng.randint(0, 40, (2, 7))
    mask = np.ones((2, 7), bool)
    mask[1, 5:] = False
    jemb = jbert.module.apply({"params": jbert_params}, jnp.asarray(ids),
                              jnp.asarray(mask))[0]
    with torch.no_grad():
        temb = tbert(torch.from_numpy(ids), torch.from_numpy(mask))
    close(temb, jemb)
    images = rng.randn(2, 64, 96, 3).astype(np.float32)
    jm = jg.GroundingDINO("swinT", 16, 1, 1)
    want = jax.jit(lambda *a: jm.apply({"params": jparams}, *a))(
        jnp.asarray(images), jemb, jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(images), torch.from_numpy(
            np.array(jemb)), torch.from_numpy(mask))
    finite = np.isfinite(np.asarray(want[0]))
    close(got[0].numpy()[finite], np.asarray(want[0])[finite])
    close(got[1], want[1])


def test_checkpoint_map_refuses_wrong_keys():
    keys, _ = tman.gdino_manifest("swinT", 1, 1, 16, 1, bert_vocab=8)
    sd = tman.synth_state_dict(keys)
    sd["transformer.extra.weight"] = np.zeros(2, np.float32)
    del sd["feat_map.bias"]
    with pytest.raises(ValueError, match="feat_map.bias.*extra"):
        tconvert(sd, "swinT", 1, 1)
