"""Parity of coin_tpu_torch's model modules with the JAX package's on the
CPU, with the JAX weights carried across by ``from_jax_variables``.

The detector is the tiny build of ``__graft_entry__._build(tiny=True)``
(full-width RN50 trunk, a 2-layer 64-wide text tower) in f32, on a
64 x 128 canvas. Weights are drawn with numpy from a seed at scales that
keep activations of order one, so that a stated absolute tolerance means
the same everywhere. Tolerance: rtol = atol = 1e-4 for the backbone,
res5, the RPN head, the text tower and the predictor (f32 convolutions
and matmuls summed in another order).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from coin_tpu.models import anchors as janchors
from coin_tpu.models.clip_resnet import Res5Head
from coin_tpu_torch.convert_from_jax import from_jax_variables
from coin_tpu_torch.device import parity_numerics
from coin_tpu_torch.models import anchors as tanchors
from coin_tpu_torch.models.detector import OpenVocabularyRCNN

TOL = dict(rtol=1e-4, atol=1e-4)
CANVAS = (64, 128)
NUM_CLASSES = 3


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op torch threads in every module that imports this
    fixture: the suite runs beside other pytest workers, where torch's
    default of one thread per core oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _init_leaf(rng, path, shape):
    """A numpy draw for one flax parameter, by its name."""
    name = "/".join(str(getattr(p, "key", p)) for p in path)
    if name.endswith("running_var"):
        return rng.uniform(0.5, 1.5, shape)
    if name.startswith("params/box_predictor") and name.endswith("bias"):
        return np.zeros(shape)                   # rows must score apart
    if name.endswith(("running_mean", "bias")):
        return 0.1 * rng.randn(*shape)
    if name.endswith(("bn3/weight", "downsample_bn/weight")):
        return rng.uniform(0.1, 0.3, shape)      # tame the residual sums
    if name.endswith(("weight", "scale")):
        return rng.uniform(0.8, 1.2, shape)
    if name.endswith("embedding"):               # class tokens must matter
        return rng.randn(*shape)
    if len(shape) == 3 and name.endswith(("query/kernel", "key/kernel",
                                          "value/kernel")):
        fan_in = shape[0]
    else:
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    return rng.randn(*shape) / np.sqrt(fan_in)


@functools.lru_cache(maxsize=None)
def tiny_pair(seed: int = 0):
    """(jax_model, pcfg, tokens, numpy variables, torch model) sharing one
    set of weights. The JAX tree's shapes come from ``jax.eval_shape``, so
    nothing is compiled for the init."""
    jmodel, pcfg, tokens = _build(num_classes=NUM_CLASSES, tiny=True)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.key(0),
        jnp.zeros((1, *CANVAS, 3), jnp.float32), tokens,
        jnp.zeros((1, 1, 4), jnp.float32))
    rng = np.random.RandomState(seed)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(_init_leaf(rng, p, s.shape), np.float32),
        shapes)
    parity_numerics()
    tmodel = OpenVocabularyRCNN(num_classes=NUM_CLASSES, text_layers=2,
                                text_width=64, text_heads=2).eval()
    tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, pcfg, tokens, variables, tmodel


def random_rois(rng, b, n, hw=CANVAS):
    xy = rng.uniform(-10, max(hw), (b, n, 2))
    wh = rng.uniform(2, 70, (b, n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def _apply(pair, method, *args):
    jmodel, _, _, variables, _ = pair
    return np.asarray(jmodel.apply(variables, *map(jnp.asarray, args),
                                   method=method))


def test_from_jax_variables_covers_every_tensor(pair):
    *_, variables, tmodel = pair
    sd = from_jax_variables(variables)
    assert set(sd) == set(tmodel.state_dict())
    w = variables["params"]["backbone"]["conv1"]["kernel"]        # HWIO
    np.testing.assert_array_equal(sd["backbone.conv1.weight"].numpy(),
                                  w.transpose(3, 2, 0, 1))
    q = variables["params"]["text_trunk"]["resblock_0"]["attn"]["query"]
    np.testing.assert_array_equal(
        sd["text_trunk.resblock_0.attn.query.weight"].numpy(),
        q["kernel"].reshape(64, 64).T)


def test_backbone_matches_jax(pair, rng):
    images = rng.randn(2, *CANVAS, 3).astype(np.float32)
    want = _apply(pair, "features", images)
    with torch.no_grad():
        got = pair[-1].features(torch.from_numpy(images)).numpy()
    assert got.shape == (2, CANVAS[0] // 16, CANVAS[1] // 16, 1024)
    np.testing.assert_allclose(got, want, **TOL)


def test_rpn_head_matches_jax(pair, rng):
    feats = rng.randn(2, 4, 8, 1024).astype(np.float32)
    want_obj, want_d = pair[0].apply(pair[3], jnp.asarray(feats),
                                     method="rpn")
    with torch.no_grad():
        obj, d = pair[-1].rpn(torch.from_numpy(feats))
    np.testing.assert_allclose(obj.numpy(), np.asarray(want_obj), **TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), **TOL)


def test_res5_matches_jax(pair, rng):
    """The res5 head on a crop batch, through pool_boxes (RoIAlign → res5
    → mean pool) and on its own."""
    jmodel, _, _, variables, tmodel = pair
    feats = rng.randn(2, 4, 8, 1024).astype(np.float32)
    rois = random_rois(rng, 2, 6)
    want = _apply(pair, "pool_boxes", feats, rois)
    with torch.no_grad():
        got = tmodel.pool_boxes(torch.from_numpy(feats),
                                torch.from_numpy(rois)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    crops = rng.randn(3, 14, 14, 1024).astype(np.float32)
    want = np.asarray(Res5Head(50).apply(
        {"params": variables["params"]["res5"]}, jnp.asarray(crops)))
    with torch.no_grad():
        got = tmodel.res5(torch.from_numpy(crops)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_text_tower_matches_jax(pair, rng):
    """Prompted class features and the plain trunk on random tokens
    (EOT = argmax token)."""
    _, _, tokens, _, tmodel = pair
    want = _apply(pair, "text_features", tokens)
    with torch.no_grad():
        got = tmodel.text_features(
            torch.from_numpy(np.array(tokens)).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    toks = rng.randint(1, 400, (3, 77)).astype(np.int32)
    toks[:, 20:] = 0
    toks[np.arange(3), [5, 9, 19]] = 49407
    want = _apply(pair, "encode_text", toks)
    with torch.no_grad():
        got = tmodel.text_trunk(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_predictor_matches_jax(pair, rng):
    pooled = rng.randn(2, 5, 2048).astype(np.float32)
    text = rng.randn(NUM_CLASSES + 1, 1024).astype(np.float32)
    jmodel, _, _, variables, tmodel = pair
    want = jmodel.apply(variables, jnp.asarray(pooled), jnp.asarray(text),
                        method="predict")
    with torch.no_grad():
        got = tmodel.predict(torch.from_numpy(pooled), torch.from_numpy(text))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_anchor_copy_matches_jax():
    np.testing.assert_array_equal(tanchors.grid_anchors(3, 5, 16),
                                  janchors.grid_anchors(3, 5, 16))


def test_config_reads_shipped_recipe():
    """The port's config copy reads foggy_fast.yaml through its _BASE_
    chain into the eval settings of the shipped recipe."""
    from coin_tpu.config import load_config as jload
    from coin_tpu_torch.config import load_config
    from coin_tpu_torch.engine.pipelines import pipeline_config_from
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs/coin/GDINO/foggy_fast.yaml")
    cfg = load_config(path)
    assert cfg == jload(path)
    p = pipeline_config_from(cfg, 8)
    assert (p.pre_nms_topk_test, p.post_nms_topk_test, p.test_topk) \
        == (6000, 1000, 100)
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16"
