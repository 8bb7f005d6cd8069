"""The port's GLIP teacher against the JAX package's on the CPU: K8's plain
version, every GLIP module and the whole tiny model, the resizes,
post-processing, the manifest and the official-checkpoint map. The same
numpy inputs and one set of weights go through both packages
(``convert_from_jax.load_jax_params``, or each package's own checkpoint
map).

Tolerances, f32: K8's plain version 1e-5 of the output's largest magnitude
(the same samples, each tap's product summed in another order); the
resizes 1e-6; the modules and the tiny model 1e-4 (as
tests/test_torch_gdino.py); post-processing gives the same rows and
classes, boxes, scores and probs to 1e-6; manifests are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coin_tpu.models import gdino as jg
from coin_tpu.models import glip as jglip
from coin_tpu.models import glip_detector as jgd
from coin_tpu.models import manifests as jman
from coin_tpu.models.convert_gdino import bert_params_from_checkpoint
from coin_tpu.models.convert_glip import convert_glip as jconvert
from coin_tpu_torch.models import gdino as tg
from coin_tpu_torch.models import glip as tglip
from coin_tpu_torch.models import glip_detector as tgd
from coin_tpu_torch.models import manifests as tman
from coin_tpu_torch.models.bert import BertModel
from coin_tpu_torch.models.convert_gdino import bert_state_dict
from coin_tpu_torch.models.convert_glip import BERT_PREFIX
from coin_tpu_torch.models.convert_glip import convert_glip as tconvert
from test_torch_gdino import close, loaded, random_params, run_pair
from tests.test_torch_models import two_torch_threads  # noqa: F401

# five levels whose stage-to-stage ratios are not integers: the FPN's
# nearest and the high branch's bilinear upsampling at odd sizes
LEVELS = [(9, 13), (5, 7), (3, 4), (2, 2), (1, 1)]


def _tensors(args):
    return [torch.from_numpy(a) if isinstance(a, np.ndarray)
            else [torch.from_numpy(x) for x in a] if isinstance(a, list)
            else a for a in args]


def run_lists(jmodule, params, tmodule, *args):
    """run_pair for modules that take lists of arrays: JAX's apply jitted
    over every array, the port's forward on the same inputs."""
    jout = jax.jit(lambda p, a: jmodule.apply({"params": p}, *a))(
        params, [jnp.asarray(a) if isinstance(a, np.ndarray)
                 else [jnp.asarray(x) for x in a] for a in args])
    with torch.no_grad():
        tout = tmodule(*_tensors(args))
    return jout, tout


def _lang(rng, t=7):
    lang = rng.randn(2, t, 768).astype(np.float32)
    mask = np.ones((2, t), bool)
    mask[1, t - 2:] = False
    return lang, mask


# -------------------------------------------------------------------- K8
def _deform_inputs(rng, stride, cin=16, cout=8, hw=(9, 11)):
    h, w = hw
    ho, wo = -(-h // stride), -(-w // stride)
    x = rng.randn(2, h, w, cin).astype(np.float32)
    offsets = rng.uniform(-2.5, 2.5, (2, ho, wo, 18)).astype(np.float32)
    offsets[0, 0, 0, :2] = -1.0                  # an integer offset, outside
    offsets[1, -1, -1, 16:] = 2.0                # the last tap past the edge
    mask = (1 / (1 + np.exp(-rng.randn(2, ho, wo, 9)))).astype(np.float32)
    kernel = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(
        np.float32)
    bias = (0.1 * rng.randn(cout)).astype(np.float32)
    return x, offsets, mask, kernel, bias


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv3x3_matches_jax(rng, stride):
    x, offsets, mask, kernel, bias = _deform_inputs(rng, stride)
    want = jglip.deform_conv3x3(*map(jnp.asarray, (x, offsets, mask, kernel,
                                                   bias)), stride)
    got = tglip.deform_conv3x3(*map(torch.from_numpy, (x, offsets, mask,
                                                       kernel, bias)),
                               stride)
    assert got.dtype == torch.float32 and got.shape == want.shape
    close(got, want, 1e-5)
    # some taps sample outside the map, and the mask is not 1
    ho, wo = offsets.shape[1:3]
    py = (np.arange(ho)[:, None, None] * stride
          + np.arange(9)[None, None, :] // 3 - 1 + offsets[..., 0::2])
    assert (py < 0).any() and (py > x.shape[1] - 1).any()
    assert mask.min() < 0.2 and mask.max() > 0.8


def test_deform_conv3x3_with_zero_offsets_is_a_conv(rng):
    """Zero offsets and a unit mask: the zero-padded 3×3 conv."""
    x, offsets, mask, kernel, bias = _deform_inputs(rng, 1, cin=8, cout=4)
    got = tglip.deform_conv3x3(torch.from_numpy(x), torch.zeros_like(
        torch.from_numpy(offsets)), torch.ones_like(torch.from_numpy(mask)),
        torch.from_numpy(kernel), torch.from_numpy(bias))
    want = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(kernel).permute(3, 2, 0, 1),
        torch.from_numpy(bias), padding=1).permute(0, 2, 3, 1)
    close(got, want, 1e-5)


# ----------------------------------------------------------------- resizes
@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_resizes_match_jax(rng, method):
    """At GLIP-L's 10 × 19 → 19 × 38 and at odd stage sizes."""
    for (h, w), (oh, ow) in (((10, 19), (19, 38)), ((5, 7), (9, 13)),
                             ((2, 3), (3, 5)), ((4, 6), (8, 12))):
        x = rng.randn(2, h, w, 5).astype(np.float32)
        want = jax.image.resize(jnp.asarray(x), (2, oh, ow, 5), method)
        fn = tglip.resize_nearest if method == "nearest" \
            else tglip.resize_bilinear
        close(fn(torch.from_numpy(x), oh, ow), want, 1e-6)
    if method == "nearest":   # where the ratio is not an integer
        assert not torch.equal(
            tglip.resize_nearest(torch.arange(5.0).reshape(1, 5, 1, 1), 9,
                                 1),
            torch.nn.functional.interpolate(
                torch.arange(5.0).reshape(1, 1, 5, 1), size=(9, 1),
                mode="nearest").permute(0, 2, 3, 1))


# ----------------------------------------------------------------- modules
def _module_case(name, rng):
    x = rng.randn(2, 9, 11, 32).astype(np.float32)
    off = rng.uniform(-2, 2, (2, 5, 6, 18)).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 5, 6, 9)).astype(np.float32)
    lang, lmask = _lang(rng)
    vis = rng.randn(2, 30, 256).astype(np.float32)
    return {
        "Conv3x3Norm": (jglip.Conv3x3Norm(), tglip.Conv3x3Norm(cin=32),
                        (x, off, mask, 2)),
        "DyReLU": (jglip.DyReLU(), tglip.DyReLU(),
                   (rng.randn(2, 5, 7, 256).astype(np.float32),)),
        "BertEncoderLayer": (jglip.BertEncoderLayer(),
                             tglip.BertEncoderLayer(), (lang, lmask)),
        "BiMultiHeadAttention_l_dim": (
            jg.BiMultiHeadAttention(dim=256, heads=8, embed=2048,
                                    l_dim=768),
            tg.BiMultiHeadAttention(256, heads=8, embed=2048, l_dim=768),
            (vis, lang, lmask)),
    }[name]


@pytest.mark.parametrize("name", ["Conv3x3Norm", "DyReLU",
                                  "BertEncoderLayer",
                                  "BiMultiHeadAttention_l_dim"])
def test_glip_module_matches_jax(rng, name):
    jm, tm, args = _module_case(name, rng)
    p = random_params(jm, rng, *args)
    want, got = run_pair(jm, p, loaded(tm, p), *args)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        close(g, w)


def test_fpn_matches_jax_at_odd_stage_sizes(rng):
    feats = [rng.randn(2, h, w, c).astype(np.float32)
             for (h, w), c in zip(LEVELS[:3], (16, 32, 64))]
    jm = jglip.FPN()
    p = random_params(jm, rng, feats)
    want, got = run_lists(jm, p, loaded(tglip.FPN((16, 32, 64)), p), feats)
    assert [tuple(g.shape[1:3]) for g in got] == LEVELS[:3] + [(2, 2),
                                                              (1, 1)]
    for g, w in zip(got, want):
        close(g, w)


@pytest.fixture(scope="module")
def block_case():
    rng = np.random.RandomState(11)
    feats = [rng.randn(2, h, w, 256).astype(np.float32) for h, w in LEVELS]
    lang, lmask = _lang(rng)
    jm = jglip.VLDyHeadBlock()
    p = random_params(jm, rng, feats, lang, lmask)
    return jm, p, loaded(tglip.VLDyHeadBlock(), p), (feats, lang, lmask)


def test_vldyhead_block_matches_jax(block_case):
    jm, p, tm, args = block_case
    (jlevels, jlang), (tlevels, tlang) = run_lists(jm, p, tm, *args)
    close(tlang, jlang)
    for g, w in zip(tlevels, jlevels):
        close(g, w)
    # the stages compose to the block
    feats, lang, lmask = _tensors(args)
    with torch.no_grad():
        f, lg = tm.fuse(feats, lang, lmask)
        levels = tm.dyconv(f)
        lg = tm.language(lg, lmask)
    assert torch.equal(lg, tlang)
    assert all(torch.equal(a, b) for a, b in zip(levels, tlevels))


def test_glip_head_matches_jax(block_case):
    rng = np.random.RandomState(12)
    feats, lang, _ = block_case[3]
    jm = jglip.GLIPHead()
    p = random_params(jm, rng, feats, lang)
    want, got = run_lists(jm, p, loaded(tglip.GLIPHead(), p), feats, lang)
    for g, w in zip(got, want):
        close(g, w)


# --------------------------------------------------------------- the model
@jax.jit
def _japply_tiny(params, images, embeds, mask):
    return jglip.GLIP(variant="swinT", num_blocks=1).apply(
        {"params": params}, images, embeds, mask)[:3]


@pytest.fixture(scope="module")
def tiny_glip():
    """swinT, one VLDyHead block, 2 × 64 × 96, 7 tokens (one padded)."""
    rng = np.random.RandomState(5)
    images = rng.randn(2, 64, 96, 3).astype(np.float32)
    embeds = rng.randn(2, 7, 768).astype(np.float32)
    mask = np.ones((2, 7), bool)
    mask[1, 6] = False
    p = random_params(jglip.GLIP(variant="swinT", num_blocks=1), rng,
                      images[:1], embeds[:1], mask[:1])
    tm = loaded(tglip.GLIP("swinT", 1), p)
    want = _japply_tiny(p, *map(jnp.asarray, (images, embeds, mask)))
    return tm, (images, embeds, mask), jax.device_get(want)


def test_glip_matches_jax(tiny_glip):
    tm, args, want = tiny_glip
    with torch.no_grad():
        *got, shapes = tm(*map(torch.from_numpy, args))
    assert shapes == [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    assert got[0].shape == (2, 129, 7) and got[1].shape == (2, 129, 4)
    for g, w in zip(got, want):
        close(g, w)


def test_glip_stages_compose(tiny_glip):
    tm, args, _ = tiny_glip
    images, embeds, mask = map(torch.from_numpy, args)
    with torch.no_grad():
        levels = tm.fpn(tm.backbone(images))
        lang = embeds
        for blk in tm.blocks():
            levels, lang = blk(levels, lang, mask)
        staged = tm.head(levels, lang)
        whole = tm(images, embeds, mask)
    for a, b in zip(staged, whole):
        assert torch.equal(a, b)
    x = torch.zeros(1, 19, 38, 256)      # P6/P7 pad (1, 1), not 'SAME'
    assert tm.fpn.top_p6.padding == (1, 1)
    assert tuple(tglip.conv_nhwc(tm.fpn.top_p6, x).shape) == (1, 10, 19,
                                                              256)


# --------------------------------------------------------- post-processing
SHAPES = [(4, 4), (2, 2), (1, 1), (1, 1), (1, 1)]


@pytest.mark.parametrize("capacity", [8, 20])
def test_postprocess_glip_matches_jax(rng, capacity):
    r, t, c = sum(h * w for h, w in SHAPES), 8, 3
    logits = (2 * rng.randn(2, r, t)).astype(np.float32)
    logits[:, 5] = logits[:, 2]                      # tied anchors
    logits[:, 9] = logits[:, 2]
    deltas = np.concatenate([rng.uniform(-10, 10, (2, r, 2)),   # spread
                             rng.uniform(-12, -8, (2, r, 2))],  # small
                            -1).astype(np.float32)
    centerness = rng.randn(2, r).astype(np.float32)
    centerness[:, [5, 9]] = centerness[:, 2:3]
    pm = tgd.positive_map_from_spans([(1, 3), (4, 5), (5, 7)], t)
    anchors = tgd.glip_anchors(SHAPES)
    np.testing.assert_array_equal(anchors, jgd.glip_anchors(SHAPES))
    hw = np.asarray([[200.0, 240.0], [180.0, 260.0]], np.float32)
    kw = dict(num_classes=c, threshold=0.1, pre_topk=16, capacity=capacity)
    want = jax.vmap(lambda lg, dl, ct, h: jgd.postprocess_glip(
        lg, dl, ct, jnp.asarray(anchors), jnp.asarray(pm), h, **kw))(
            *map(jnp.asarray, (logits, deltas, centerness, hw)))
    got = tgd.postprocess_glip(
        *map(torch.from_numpy, (logits, deltas, centerness, anchors, pm,
                                hw)), **kw)
    assert got.boxes.shape == (2, min(16, capacity), 4)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    n = got.valid.sum(-1)
    assert (n > 0).all() and (n == capacity).any() == (capacity == 8)
    for f in ("boxes", "scores", "probs"):
        close(getattr(got, f), getattr(want, f), 1e-6)


# ------------------------------------------------------ official checkpoint
@pytest.mark.parametrize("variant,blocks", [("swinL", 8), ("swinT", 1)])
def test_glip_manifest_matches_jax(variant, blocks):
    assert tman.glip_manifest(variant, blocks) == \
        jman.glip_manifest(variant, blocks)


def _reduced_checkpoint(rng):
    """swinT, one block, 2 classes, a 1-layer BERT with 40 rows; norms,
    the level scales and the gammas near 1 keep activations away from 0."""
    keys, _ = tman.glip_manifest("swinT", 1, 2, bert_layers=1,
                                 bert_vocab=40)
    sd = tman.synth_state_dict(keys, seed=7)
    for k, v in sd.items():
        if v.ndim == 1 and ("norm" in k or "LayerNorm" in k or ".bn." in k
                            or "gamma" in k or "scales" in k) \
                and not k.endswith(".bias"):
            sd[k] = (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
    for k in [k for k in sd if ".DyConv." in k or ".offset." in k
              or "fpn" in k or "dot_product" in k]:
        if sd[k].ndim > 1:            # fan-in scaled, so levels stay O(1)
            sd[k] = (rng.randn(*sd[k].shape) / np.sqrt(
                np.prod(sd[k].shape[1:]))).astype(np.float32)
    return sd


def test_checkpoint_map_matches_jax_convert(rng):
    """One reduced official-layout checkpoint through each package's own
    map: the models and the BERTs agree."""
    sd = _reduced_checkpoint(rng)
    sd["module.rpn.head.bias0"] = sd.pop("rpn.head.bias0")   # DataParallel
    jparams = jconvert(dict(sd), "swinT", num_blocks=1)
    tm = tglip.GLIP("swinT", 1)
    tm.load_state_dict(tconvert(sd, "swinT"), strict=True)
    jsd = {k.replace("module.", ""): torch.from_numpy(v)
           for k, v in sd.items()}
    jbert, jbert_params = bert_params_from_checkpoint(jsd, BERT_PREFIX)
    bcfg, bsd = bert_state_dict(sd, BERT_PREFIX)
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
    want = _japply_tiny(jparams, jnp.asarray(images), jemb,
                        jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(images), torch.from_numpy(np.array(jemb)),
                 torch.from_numpy(mask))
    for g, w in zip(got[:3], want):
        close(g, w)


def test_checkpoint_map_refuses_wrong_keys(rng):
    sd = _reduced_checkpoint(rng)
    sd["rpn.head.extra.weight"] = np.zeros(2, np.float32)
    del sd["rpn.head.dyhead_tower.2.offset.bias"]
    with pytest.raises(ValueError, match="offset.bias.*extra"):
        tconvert(sd, "swinT")
