"""The port's CLIP re-scorer (stage 1b) against the JAX package's on the
CPU: the BPE tokenizer, the OpenAI-checkpoint maps, ``AttentionPool2d``,
``CLIPScorer``, the CLIP assets of ``engine/clip_setup`` and the
re-scoring pass through both packages' ``build_clip_scorer``.

One random checkpoint in OpenAI CLIP RN50's layout
(``manifests.random_clip_state_dict``: the full-width visual tower, a
one-layer 128-wide text transformer) and one small BPE merges file
(``tokenizer.write_bpe_merges``: the class and template words) serve
every test; both are written to disk and each package reads them with its
own loader. The JAX factory builds its text trunk with CLIP's 12 layers
and 8 heads, so the test hands it this checkpoint's 1 layer and 2 heads
(``width / 64``, as both converters split them) through a monkeypatch.

Tolerances. f32: 1e-5 relative to the largest entry for the attention
pool and the prototypes (the same arithmetic summed in another order;
measured 6.5e-7 and 3.0e-7), 1e-4 absolute on the scorer's probabilities
and on the re-scored store's scores and probabilities (measured 6.0e-7
and 4.8e-7; boxes and classes equal). bf16: the probabilities within
``BF16_PROBS`` = 3e-3, twice JAX's own bf16 scorer's distance from its
f32 one (1.5e-3); measured 9.6e-4 for ``CLIPScorer`` and 1.7e-4 through
the factories (the frameworks round the bf16 backbone and res5 at other
places).
"""

import functools
import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coin_tpu.native
from coin_tpu.config import load_config as jload_config
from coin_tpu.data import voc as jvoc
from coin_tpu.data.loader import TestLoader as JTestLoader
from coin_tpu.engine import clip_setup as jclip
from coin_tpu.engine import cloud_factory as jcf
from coin_tpu.engine import collect as jcollect
from coin_tpu.models import clip_resnet as jres
from coin_tpu.models import clip_scorer as jscorer
from coin_tpu.models import convert as jconv
from coin_tpu.models import detector as jdet
from coin_tpu.models import text_encoder as jtext
from coin_tpu.models.tokenizer import ClipTokenizer as JTok
from coin_tpu_torch.config import load_config
from coin_tpu_torch.convert_from_jax import from_jax_variables, load_jax_params
from coin_tpu_torch.data import voc as tvoc
from coin_tpu_torch.data.loader import TestLoader as TLoader
from coin_tpu_torch.engine import clip_setup as tclip
from coin_tpu_torch.engine import cloud_factory as tcf
from coin_tpu_torch.engine import collect as tcollect
from coin_tpu_torch.engine.results_store import ResultStore
from coin_tpu_torch.models import clip_resnet as tres
from coin_tpu_torch.models import convert as tconv
from coin_tpu_torch.models.clip_scorer import CLIPScorer
from coin_tpu_torch.models.detector import OpenVocabularyRCNN
from coin_tpu_torch.models.manifests import random_clip_state_dict
from coin_tpu_torch.models.text_encoder import TextTransformer
from coin_tpu_torch.models.tokenizer import ClipTokenizer, write_bpe_merges
from tests.test_adaptation_e2e import synth_store

CLASSES = ("car", "person")
TEXT = dict(text_width=128, text_layers=1)
BF16_PROBS = 3e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(autouse=True, scope="module")
def _cpu_setup():
    """Two intra-op torch threads beside the suite's other workers; the
    JAX loaders decode with PIL, as the port does."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(coin_tpu.native, "available", lambda: False)
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip")
    sd = random_clip_state_dict(50, seed=5, **TEXT)
    ckpt = str(root / "RN50_random.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    words = [w for t in jclip.PROMPT_TEMPLATES for w in
             t.replace("{0}", "foggy").replace("{1}", "").replace(".", " ")
             .split()] + list(CLASSES) + ["background", "photo", "x"]
    bpe = str(root / "bpe_test.txt.gz")
    write_bpe_merges(bpe, words)
    jvoc.make_synthetic_voc(str(root / "synth/VOC2007"), num_images=3,
                            split="train", image_hw=(64, 96))
    for reg in (jvoc.register_pascal_voc, tvoc.register_pascal_voc):
        reg("tclipsynth", "synth/VOC2007", "train", CLASSES, ".jpg")
    return dict(root=str(root), sd=sd, ckpt=ckpt, bpe=bpe,
                tsd=tconv.load_torch_state_dict(ckpt),
                jsd=jconv.load_torch_state_dict(ckpt))


def _cfg(cfg, assets):
    cfg.DATASETS.ROOT = assets["root"]
    cfg.DATASETS.TRAIN_UNLABEL = ["tclipsynth"]
    cfg.DATASETS.STYLE_NAME = "foggy"
    cfg.TPU.CLIP_WEIGHTS = assets["ckpt"]
    cfg.TPU.CLIP_BPE_VOCAB = assets["bpe"]
    return cfg


# ------------------------------------------------------------- tokenizer
def test_clip_tokenizers_agree(assets):
    jt, tt = JTok(assets["bpe"]), ClipTokenizer(assets["bpe"])
    assert tt.encoder == jt.encoder and tt.bpe_ranks == jt.bpe_ranks
    texts = ["a photo of a X X X X car.", "There is a person in the foggy "
             "scene.", "A BIG  car's   wheels, 12 of them!",
             "&amp; café naïve über-bicycle", "background"]
    for t in texts:
        assert tt.encode(t) == jt.encode(t), t
    np.testing.assert_array_equal(tt.tokenize(texts), jt.tokenize(texts))
    with pytest.raises(RuntimeError, match="too long"):
        tt.tokenize("car " * 80)


# ---------------------------------------------------------- checkpoint map
def test_convert_maps_agree(assets):
    """Each port map equals the JAX map's tree carried over by
    ``convert_from_jax`` (its generic rules: HWIO → OIHW, Dense
    transposes, the attention's (in, heads, head_dim) kernels), and the
    JAX scorer's tree loads strictly into the port's ``CLIPScorer``."""
    tsd, jsd = assets["tsd"], assets["jsd"]
    layers = jres.DEPTH_CFG[50]["layers"]
    jparts = jconv.convert_clip_visual(jsd, layers)
    tparts = tconv.convert_clip_visual(tsd, layers)
    jparts += (jconv.convert_clip_text(jsd),)
    tparts += (tconv.convert_clip_text(tsd),)
    for j, t in zip(jparts, tparts):
        want = from_jax_variables(j)
        assert sorted(t) == sorted(want)
        for k in t:
            assert torch.equal(t[k], want[k]), k
    assert tconv.logit_scale_from(tsd) == jconv.logit_scale_from(jsd)
    # the JAX CLIPScorer's tree loads strictly into the port's scorer
    scorer = load_jax_params(CLIPScorer(50), {"params": dict(
        zip(("backbone", "res5", "attnpool"), jparts[:3]))})
    assert torch.equal(scorer.attnpool.c_proj.weight,
                       tparts[2]["c_proj.weight"])
    assert tconv.text_geometry(tsd) == dict(
        width=128, heads=2, layers=1, embed_dim=1024, vocab_size=49408,
        context_length=77)


# ---------------------------------------------------------- attention pool
@pytest.mark.parametrize("hw", [(7, 7), (9, 11), (4, 5)])
def test_attention_pool_matches_jax(assets, hw):
    """7 x 7 uses the embedding as it is; 9 x 11 (upsampling) and 4 x 5
    (downsampling, antialiased) resize its spatial part as
    ``jax.image.resize`` does."""
    attn = jconv.convert_clip_visual(assets["jsd"], (3, 4, 6, 3))[2]
    jmod = jres.AttentionPool2d(embed_dim=2048, num_heads=32,
                                output_dim=1024)
    x = np.random.RandomState(hw[0]).randn(3, *hw, 2048).astype(np.float32)
    want = np.asarray(jmod.apply({"params": attn}, jnp.asarray(x)))
    tmod = tres.AttentionPool2d(2048, 32, 1024)
    tmod.load_state_dict(tconv.convert_clip_visual(assets["tsd"])[2])
    got = tmod(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == (3, 1024)
    assert _rel(got, want) < 1e-5


def test_jax_resize_matrix_matches_jax_image_resize():
    x = np.random.RandomState(0).randn(7, 7, 3).astype(np.float32)
    for h, w in ((9, 11), (4, 5), (7, 3), (14, 14)):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (h, w, 3),
                                           method="bilinear"))
        got = torch.einsum("yi,xj,ijc->yxc", tres.jax_resize_matrix(7, h),
                           tres.jax_resize_matrix(7, w),
                           torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- the scorer
def _scorer_inputs(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randn(2, 64, 96, 3).astype(np.float32)
    xy = rng.uniform(0, 60, (2, 5, 2))
    wh = rng.uniform(8, 40, (2, 5, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    text = rng.randn(3, 1024).astype(np.float32)
    return images, boxes, text


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_scorer_matches_jax(assets, dtype):
    backbone, res5, attn = jconv.convert_clip_visual(assets["jsd"])
    images, boxes, text = _scorer_inputs()
    scale = jconv.logit_scale_from(assets["jsd"])
    jmod = jscorer.CLIPScorer(depth=50, compute_dtype=getattr(jnp, dtype))
    want = np.asarray(jmod.apply(
        {"params": {"backbone": backbone, "res5": res5, "attnpool": attn}},
        jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(text),
        jnp.asarray(scale)))
    tmod = CLIPScorer(50, compute_dtype=getattr(torch, dtype))
    tb, tr, ta = tconv.convert_clip_visual(assets["tsd"])
    tmod.backbone.load_state_dict(tb)
    tmod.res5.load_state_dict(tr)
    tmod.attnpool.load_state_dict(ta)
    with torch.no_grad():
        got = tmod(torch.from_numpy(images), torch.from_numpy(boxes),
                   torch.from_numpy(text), scale).numpy()
    assert got.shape == (2, 5, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    err = np.abs(got - want).max()
    assert err < (1e-4 if dtype == "float32" else BF16_PROBS), err


# ------------------------------------------------------------ clip_setup
def test_setup_clip_assets_and_template_prototypes(assets):
    """The class tokens of both ``setup_clip_assets`` (with the
    'background' row appended once) and the template-mean prototypes of
    both ``template_prototypes`` through the same text trunk."""
    jcfg = _cfg(jload_config(), assets)
    tcfg = _cfg(load_config(), assets)
    for names in (CLASSES, CLASSES + ("background",)):
        jt, jtok = jclip.setup_clip_assets(jcfg, names)
        tt, ttok = tclip.setup_clip_assets(tcfg, names)
        np.testing.assert_array_equal(tt, jt)
        assert tt.shape == (3, 77) and ttok.encoder == jtok.encoder
    tcfg.TPU.CLIP_BPE_VOCAB = ""
    simple, none = tclip.setup_clip_assets(tcfg, CLASSES)
    assert none is None and simple.shape == (3, 77)

    jparams = jconv.convert_clip_text(assets["jsd"])
    jtrunk = jtext.TextTransformer(embed_dim=1024, width=128, heads=2,
                                   layers=1)
    encode = jax.jit(lambda t: jtrunk.apply({"params": jparams}, t))
    names = list(CLASSES) + ["background"]
    want = jclip.template_prototypes(encode, jtok, names, "foggy")
    trunk = TextTransformer(**tconv.text_geometry(assets["tsd"]))
    trunk.load_state_dict(tconv.convert_clip_text(assets["tsd"]))
    got = tclip.template_prototypes(trunk, ttok, names, "foggy")
    assert got.shape == (3, 1024)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("region", [False, True])
def test_load_clip_into_model_matches_jax(assets, tmp_path, region):
    """Every tensor ``load_clip_into_variables`` writes into an attnpool
    detector with a 2-layer text tower (one layer's tensors in the
    checkpoint) equals the port's after ``load_clip_into_model``; with
    ``region``, visual and text tensors come from a RegionCLIP checkpoint
    ('backbone.*', 'lang_encoder.*'), logit_scale from the OpenAI one."""
    region_path, src = "", assets["sd"]        # drawn with seed 5
    if region:
        other = src = random_clip_state_dict(50, seed=6, **TEXT)
        rsd = {("backbone." + k[len("visual."):] if k.startswith("visual.")
                else "lang_encoder." + k): torch.from_numpy(v)
               for k, v in other.items() if k != "logit_scale"}
        region_path = str(tmp_path / "regionclip.pth")
        torch.save({"model": rsd}, region_path)
    jmodel = jdet.OpenVocabularyRCNN(num_classes=2, pooling="attnpool",
                                     text_layers=2, text_width=128,
                                     text_heads=2)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((3, 77), jnp.int32), jnp.zeros((1, 1, 4)))
    jvars, jscale = jclip.load_clip_into_variables(
        shapes, assets["ckpt"], 50, region_clip_path=region_path)
    loaded = jax.tree_util.tree_map(
        lambda v: None if isinstance(v, jax.ShapeDtypeStruct)
        else np.asarray(v), jvars["params"])
    want = from_jax_variables(_prune(loaded))
    tmodel = OpenVocabularyRCNN(num_classes=2, text_layers=2, text_width=128,
                                text_heads=2, pooling="attnpool")
    _, tscale = tclip.load_clip_into_model(tmodel, assets["ckpt"], 50,
                                           region_clip_path=region_path)
    own = tmodel.state_dict()
    assert tscale == jscale == pytest.approx(np.log(100.0), rel=1e-6)
    assert any(k.startswith("attnpool.") for k in want)
    assert not any(k.startswith("text_trunk.resblock_1.") for k in want)
    for k, v in want.items():
        assert torch.equal(own[k], v), k
    np.testing.assert_array_equal(own["backbone.conv1.weight"].numpy(),
                                  src["visual.conv1.weight"])


def _prune(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _prune(v)
            if v:
                out[k] = v
        elif v is not None:
            out[k] = v
    return out


# ------------------------------------------------ the re-scoring pass
def _builders(monkeypatch, f32: bool):
    """Both factories, with the JAX trunk at this checkpoint's depth and
    heads, and with ``f32`` both scorers in f32."""
    monkeypatch.setattr(jtext, "TextTransformer", functools.partial(
        jtext.TextTransformer, heads=2, layers=1))
    if f32:
        jcls, tcls = jscorer.CLIPScorer, CLIPScorer
        monkeypatch.setattr(jscorer, "CLIPScorer", lambda depth, **_: jcls(
            depth=depth, compute_dtype=jnp.float32))
        monkeypatch.setattr(tcf, "CLIPScorer", lambda depth, **_: tcls(
            depth, compute_dtype=torch.float32))


def _loaders(assets):
    kw = dict(batch_size=2, min_size=64, max_size=96)
    return (JTestLoader("tclipsynth", assets["root"], **kw),
            TLoader("tclipsynth", assets["root"], **kw))


def test_rescore_with_clip_store_matches_jax(assets, monkeypatch, tmp_path):
    """``rescore_with_clip`` through each package's ``build_clip_scorer``
    (both scorers in f32) over the same store: the same rows, classes,
    boxes, scores and probabilities."""
    _builders(monkeypatch, f32=True)
    jl, tl = _loaders(assets)
    jstore = synth_store(jl.records, num_classes=2)
    npz = str(tmp_path / "cloud.npz")
    jstore.save(npz)
    jout = jcollect.rescore_with_clip(
        jcf.build_clip_scorer(_cfg(jload_config(), assets), CLASSES),
        jstore, jl, capacity=8)
    tout = tcollect.rescore_with_clip(
        tcf.build_clip_scorer(_cfg(load_config(), assets), CLASSES,
                              device="cpu"),
        ResultStore.load(npz), tl, capacity=8, device="cpu")
    assert sorted(tout.image_ids()) == sorted(jout.image_ids())
    rows = 0
    for i in jout.image_ids():
        for view in ("RCNN", "RPN"):
            j, t = jout.get_view(i, view), tout.get_view(i, view)
            np.testing.assert_array_equal(t["classes"], j["classes"])
            for k in ("boxes", "scores", "probs"):
                np.testing.assert_allclose(t[k], j[k], atol=1e-4, rtol=0)
            rows += len(j["classes"])
    assert rows > 0


def test_build_clip_scorer_bf16_matches_jax(assets, monkeypatch):
    """The factories as they build the scorer, in bf16 over f32
    parameters, on the same u8 batch and boxes: probabilities within
    ``BF16_PROBS``."""
    _builders(monkeypatch, f32=False)
    jl, tl = _loaders(assets)
    batch, _ = next(iter(jl))
    boxes = _scorer_inputs(1)[1]
    want = np.asarray(jcf.build_clip_scorer(
        _cfg(jload_config(), assets), CLASSES)(
            jnp.asarray(batch.images), jnp.asarray(boxes)))
    tapply = tcf.build_clip_scorer(_cfg(load_config(), assets), CLASSES,
                                   device="cpu")
    got = tapply(torch.from_numpy(batch.images),
                 torch.from_numpy(boxes)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 5, 3)
    err = np.abs(got - want).max()
    assert err < BF16_PROBS, err


def test_build_clip_scorer_needs_its_assets(assets):
    cfg = _cfg(load_config(), assets)
    cfg.TPU.CLIP_WEIGHTS = os.path.join(assets["root"], "missing.pt")
    with pytest.raises(FileNotFoundError, match="CLIP_WEIGHTS"):
        tcf.build_clip_scorer(cfg, CLASSES, device="cpu")
    cfg = _cfg(load_config(), assets)
    cfg.TPU.CLIP_BPE_VOCAB = ""
    with pytest.raises(FileNotFoundError, match="CLIP_BPE_VOCAB"):
        tcf.build_clip_scorer(cfg, CLASSES, device="cpu")
    with gzip.open(assets["bpe"], "rt") as f:
        assert f.readline().startswith("#version")


def test_attnpool_detector_from_jax_matches_jax():
    """``convert_from_jax`` carries an attnpool detector's JAX parameters
    (random values of the shapes of ``jax.eval_shape``'s init) strictly
    into the port's ``OpenVocabularyRCNN(pooling="attnpool")``, whose
    ``pool_boxes`` (RoIAlign → res5 → attention pool) and ``predict``
    match JAX's in f32 within 1e-5 of the largest entry."""
    jmodel = jdet.OpenVocabularyRCNN(num_classes=2, pooling="attnpool",
                                     text_layers=1, text_width=64,
                                     text_heads=1)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((3, 77), jnp.int32), jnp.zeros((1, 1, 4)))
    rng = np.random.RandomState(3)

    def fill(path, s):
        name, x = path[-1].key, rng.randn(*s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if name == "running_var":
            return np.abs(x) + 0.5
        if name in ("weight", "scale"):
            return 1.0 + 0.1 * x
        return 0.05 * x
    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    tmodel = OpenVocabularyRCNN(num_classes=2, text_layers=1, text_width=64,
                                text_heads=1, pooling="attnpool")
    load_jax_params(tmodel, variables)
    feats = (rng.randn(2, 5, 7, 1024) * 0.5).astype(np.float32)
    xy = rng.uniform(0, 70, (2, 4, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 40, (2, 4, 2))],
                           -1).astype(np.float32)
    text = rng.randn(3, 1024).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    jpooled = jmodel.apply(variables, jnp.asarray(feats), jnp.asarray(boxes),
                           method="pool_boxes")
    jscores = jmodel.apply(variables, jpooled, jnp.asarray(text),
                           method="predict")[0]
    with torch.no_grad():
        pooled = tmodel.pool_boxes(torch.from_numpy(feats),
                                   torch.from_numpy(boxes))
        scores = tmodel.predict(pooled, torch.from_numpy(text))[0]
    assert pooled.shape == (2, 4, 1024) and pooled.dtype == torch.float32
    assert _rel(pooled.numpy(), np.asarray(jpooled)) < 1e-5
    assert _rel(scores.numpy(), np.asarray(jscores)) < 1e-5
