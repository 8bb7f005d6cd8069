"""The port's random init against the JAX modules' own flax initialisers
on the CPU: ``OpenVocabularyRCNN.random_init`` and ``CKGNet.random_init``
draw each parameter from the distribution that the JAX module declares
(LeCun normal truncated at 2 σ for kernels, flax ``nn.Embed``'s
σ = width^-0.5 for the token embedding, plain normals where the module
names a scale, zeros and ones).

The JAX side initialises, in one jitted ``init``, every submodule at the
port's shapes (the tiny text tower, a 1-layer 32-wide trunk; the RPN
head, the attention pool, the box predictor and a 64-wide CKG net), and
the backbone's and res5's ``nn.Conv`` at one 1 x 1 and one 3 x 3 shape:
each of their convolutions is held to the JAX conv of its kernel size,
its deviation scaled by LeCun's (fan_in_jax / fan_in_port) ** 0.5 (each
JAX parameter costs XLA about 0.4 s of compilation). For each port
parameter and its JAX counterpart: the deviations agree within their
sampling noise, and a tensor of 800 values or more is truncated on one
side iff it is on the other (max |w| / σ below 2.35; a truncated normal
reaches 2.27 σ, a plain one of 800 values passes 2.35 σ but for a chance
of 3e-7).
"""

import re

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coin_tpu.models import ckg as jckg
from coin_tpu.models.clip_resnet import AttentionPool2d, _conv
from coin_tpu.models.roi_heads import BoxPredictor
from coin_tpu.models.rpn import RPNHead
from coin_tpu.models.text_encoder import PromptedTextEncoder, TextTransformer
from coin_tpu_torch.convert_from_jax import from_jax_variables
from coin_tpu_torch.models.ckg import CKGNet
from coin_tpu_torch.models.detector import OpenVocabularyRCNN
from tests.test_torch_models import two_torch_threads  # noqa: F401

TEXT = dict(text_layers=1, text_width=32, text_heads=2)
CKG = (64, 4)          # hidden size, classes with the background
TRUNCATED_BELOW = 2.35


def _conv_name(o, i, k):
    return f"conv_{o}_{i}_{k}"


class _Probe(nn.Module):
    """The JAX submodules at the port's shapes, initialised together."""
    convs: tuple           # (out, in, kernel) of each conv drawn

    @nn.compact
    def __call__(self):
        for o, i, k in self.convs:
            _conv(o, k, name=_conv_name(o, i, k))(jnp.zeros((1, k, k, i)))
        RPNHead(15, name="rpn_head")(jnp.zeros((1, 1, 1, 1024)))
        AttentionPool2d(2048, 32, 1024, name="attnpool")(
            jnp.zeros((1, 7, 7, 2048)))
        BoxPredictor(1024, name="box_predictor")(jnp.zeros((1, 1024)))
        trunk = TextTransformer(width=TEXT["text_width"],
                                heads=TEXT["text_heads"],
                                layers=TEXT["text_layers"], embed_dim=1024,
                                name="text_trunk")
        trunk(jnp.zeros((1, 77), jnp.int32))
        PromptedTextEncoder(trunk, 4, name="prompted_text")(
            jnp.zeros((4, 77, TEXT["text_width"])),
            jnp.zeros((4,), jnp.int32))
        h, c = CKG
        jckg.CKGNet(h, c, name="ckg")(
            jnp.zeros((2, h)), jnp.zeros((c, h)), jnp.zeros((c, h)),
            jnp.zeros((2, c)), jnp.zeros((2, c)))


@pytest.fixture(scope="module")
def inits():
    """(port tensors, JAX tensors by port name): the port's random_init of
    the tiny attention-pool detector and of a CKG net, and the JAX
    initialisers' draws at the same shapes."""
    model = OpenVocabularyRCNN(3, pooling="attnpool", **TEXT).random_init(0)
    port = {n: p.detach() for n, p in model.named_parameters()}
    port.update({"ckg." + n: p.detach() for n, p in
                 CKGNet(*CKG).random_init(1).named_parameters()})
    # layer3's first 1 x 1 and 3 x 3 convs stand for each kernel size
    drawn = {1: (256, 512, 1), 3: (256, 256, 3)}
    probe = _Probe(tuple(drawn.values()))
    params = jax.jit(probe.init)(jax.random.key(0))["params"]
    jparams = jax.tree_util.tree_map(np.asarray, params)
    jax_sd = from_jax_variables(
        {k: v for k, v in jparams.items() if not k.startswith("conv_")})
    jax_sd = {re.sub(r"^prompted_text\.trunk\.", "text_trunk.", k): v
              for k, v in jax_sd.items()}
    for n, p in port.items():
        if n.startswith(("backbone.", "res5.")) and p.dim() == 4:
            o, i, k = drawn[p.shape[-1]]
            w = next(iter(from_jax_variables(
                {"c": jparams[_conv_name(o, i, k)]}).values()))
            jax_sd[n] = w * (i * k * k / p[0].numel()) ** 0.5
    return port, jax_sd


def _stats(t):
    t = t.double()
    sd = float(t.std())
    return sd, (float(t.abs().max()) / sd if sd > 0 else 0.0)


def test_every_parameter_draws_from_its_flax_initialiser(inits):
    port, jax_sd = inits
    missing = sorted(n for n in port if n not in jax_sd)
    assert not missing, missing
    checked = 0
    for name, p in port.items():
        j = jax_sd[name]
        assert tuple(p.shape) == tuple(j.shape) or p.dim() == 4, name
        if float(j.std()) == 0.0:            # zeros and ones
            assert torch.equal(p, j), name
            continue
        (sp, mp), (sj, mj) = _stats(p), _stats(j)
        # the sample deviations of two draws of n values differ by about
        # sqrt(1 / n) of the deviation
        tol = 0.02 + 5.0 / np.sqrt(p.numel())
        assert abs(sp / sj - 1.0) <= tol, (name, sp, sj)
        if p.numel() >= 800:
            assert (mp < TRUNCATED_BELOW) == (mj < TRUNCATED_BELOW), \
                (name, mp, mj)
        checked += 1
    # every kernel, embedding and scale of the tiny detector and the CKG
    assert checked >= 60, checked


@pytest.mark.parametrize("name,std,truncated", [
    ("text_trunk.token_embedding.weight", 32 ** -0.5, False),
    ("text_trunk.resblock_0.attn.query.weight", 32 ** -0.5, True),
    ("backbone.layer3.0.conv2.weight", (256 * 9) ** -0.5, True),
    ("rpn_head.conv.weight", (1024 * 9) ** -0.5, True),
    ("box_predictor.trans_0.weight", 1024 ** -0.5, True),
    ("ckg.cross_online.linear_q.weight", 64 ** -0.5, True),
    ("attnpool.positional_embedding", 2048 ** -0.5, False),
    ("box_predictor.cls_score.weight", 0.01, False)])
def test_named_parameters_have_flax_scale_and_tails(inits, name, std,
                                                    truncated):
    """The parameters named in the repair, against the initialisers' own
    σ: flax's LeCun normal keeps σ = fan_in^-0.5 after its truncation;
    nn.Embed's default is a plain normal of σ = features^-0.5."""
    port, jax_sd = inits
    for t in (port[name], jax_sd[name]):
        sd, m = _stats(t)
        assert abs(sd / std - 1.0) <= 0.03, (name, sd, std)
        assert (m < TRUNCATED_BELOW) == truncated, (name, m)
