"""Official CLIP, Grounding DINO and GLIP checkpoint key manifests (the
port's copy of coin_tpu/models/manifests.py, kept so that the port
imports nothing of coin_tpu).

Each manifest lists, key by key with shapes, the state dict of the
official model definitions: openai/CLIP's ``clip/model.py``
(``ModifiedResNet``, ``AttentionPool2d``, the text ``Transformer``: the
RN50 archive); IDEA-Research/GroundingDINO's
``backbone/swin_transformer.py``, ``transformer.py``,
``fuse_modules.py`` and ``groundingdino.py``, plus HF ``BertModel`` under
``bert.`` (the ``groundingdino_swinb_cogcoor.pth`` layout); and
microsoft/GLIP's maskrcnn_benchmark fork (Swin + FPN + VLDyHead, BERT under
``language_backbone.body.model.``, the ``glip_large_model.pth`` layout).
Tests and ``chip_smoke.py`` build random checkpoints from them
(:func:`synth_state_dict`, :func:`random_clip_state_dict`; with a BPE
merges file, :func:`clip_assets`), so
``models/convert``, ``models/convert_gdino`` and ``models/convert_glip``
are held to the official key names, not to their own inverses. Buffers (non-parameter keys of the official state dicts)
are listed apart; converters ignore them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Set, Tuple

import numpy as np

Shape = Tuple[int, ...]

_SWIN = {
    # variant: (embed_dim, depths, heads, window)
    "swinT": (96, (2, 2, 6, 2), (3, 6, 12, 24), 7),
    "swinB": (128, (2, 2, 18, 2), (4, 8, 16, 32), 12),
    "swinL": (192, (2, 2, 18, 2), (6, 12, 24, 48), 12),
}


def _ln(keys: Dict[str, Shape], p: str, c: int) -> None:
    keys[f"{p}.weight"] = (c,)
    keys[f"{p}.bias"] = (c,)


def _lin(keys: Dict[str, Shape], p: str, o: int, i: int,
         bias: bool = True) -> None:
    keys[f"{p}.weight"] = (o, i)
    if bias:
        keys[f"{p}.bias"] = (o,)


_CLIP_RN = {
    # depth: (stage blocks, stem width, text width, text layers, embed
    #         (output) dim, input resolution)
    50: ((3, 4, 6, 3), 64, 512, 12, 1024, 224),
    101: ((3, 4, 23, 3), 64, 512, 12, 512, 224),
    200: ((4, 6, 10, 6), 80, 640, 12, 640, 288),    # RN50x4
    800: ((6, 8, 18, 8), 96, 768, 12, 768, 384),    # RN50x16
}


def _bn(keys: Dict[str, Shape], bufs: Set[str], p: str, c: int) -> None:
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        keys[f"{p}.{leaf}"] = (c,)
    bufs.add(f"{p}.num_batches_tracked")


def clip_resnet_manifest(depth: int = 50, text_width: int = 0,
                         text_layers: int = 0
                         ) -> Tuple[Dict[str, Shape], Set[str]]:
    """The official OpenAI CLIP RN state dict (params, buffers); a
    ``text_width`` or ``text_layers`` other than 0 shrinks the text
    transformer (tests)."""
    blocks, width, t_width, t_layers, embed_dim, res = _CLIP_RN[depth]
    t_width, t_layers = text_width or t_width, text_layers or t_layers
    keys: Dict[str, Shape] = {}
    bufs: Set[str] = set()
    keys["visual.conv1.weight"] = (width // 2, 3, 3, 3)
    _bn(keys, bufs, "visual.bn1", width // 2)
    keys["visual.conv2.weight"] = (width // 2, width // 2, 3, 3)
    _bn(keys, bufs, "visual.bn2", width // 2)
    keys["visual.conv3.weight"] = (width, width // 2, 3, 3)
    _bn(keys, bufs, "visual.bn3", width)
    inplanes = width
    for s, nblocks in enumerate(blocks):
        planes = width * (2 ** s)
        for b in range(nblocks):
            p = f"visual.layer{s + 1}.{b}"
            cin = inplanes if b == 0 else planes * 4
            keys[f"{p}.conv1.weight"] = (planes, cin, 1, 1)
            _bn(keys, bufs, f"{p}.bn1", planes)
            keys[f"{p}.conv2.weight"] = (planes, planes, 3, 3)
            _bn(keys, bufs, f"{p}.bn2", planes)
            keys[f"{p}.conv3.weight"] = (planes * 4, planes, 1, 1)
            _bn(keys, bufs, f"{p}.bn3", planes * 4)
            if b == 0:  # Sequential('-1' avgpool, '0' conv, '1' bn)
                keys[f"{p}.downsample.0.weight"] = (planes * 4, cin, 1, 1)
                _bn(keys, bufs, f"{p}.downsample.1", planes * 4)
        inplanes = planes * 4
    feat_dim, spacial = width * 32, res // 32
    keys["visual.attnpool.positional_embedding"] = (spacial * spacial + 1,
                                                    feat_dim)
    for proj in ("k_proj", "q_proj", "v_proj"):
        _lin(keys, f"visual.attnpool.{proj}", feat_dim, feat_dim)
    _lin(keys, "visual.attnpool.c_proj", embed_dim, feat_dim)
    for i in range(t_layers):
        p = f"transformer.resblocks.{i}"
        keys[f"{p}.attn.in_proj_weight"] = (3 * t_width, t_width)
        keys[f"{p}.attn.in_proj_bias"] = (3 * t_width,)
        _lin(keys, f"{p}.attn.out_proj", t_width, t_width)
        _ln(keys, f"{p}.ln_1", t_width)
        _lin(keys, f"{p}.mlp.c_fc", 4 * t_width, t_width)
        _lin(keys, f"{p}.mlp.c_proj", t_width, 4 * t_width)
        _ln(keys, f"{p}.ln_2", t_width)
    keys["token_embedding.weight"] = (49408, t_width)
    keys["positional_embedding"] = (77, t_width)
    _ln(keys, "ln_final", t_width)
    keys["text_projection"] = (t_width, embed_dim)
    keys["logit_scale"] = ()
    # jit-archive int buffers build_model() deletes (model.py:428-430)
    bufs.update({"input_resolution", "context_length", "vocab_size"})
    return keys, bufs


def random_clip_state_dict(depth: int = 50, seed: int = 0,
                           text_width: int = 0, text_layers: int = 0
                           ) -> Dict[str, np.ndarray]:
    """A random CLIP checkpoint in the official layout (the manifest's
    parameters, numpy f32) whose activations stay finite and O(1) through
    the frozen-BN ResNet: He-normal convs, BN scales near 1 (the last of
    each bottleneck near 0.2) over running variances in [0.5, 1.5],
    LeCun-normal linears, CLIP's embedding scales, logit_scale ln 100."""
    keys, _ = clip_resnet_manifest(depth, text_width, text_layers)
    rng = np.random.RandomState(seed)
    out = {}
    for k, shape in keys.items():
        leaf = k.rsplit(".", 1)[-1]
        if len(shape) == 4:                        # conv (O, I, kh, kw)
            fan_in = shape[1] * shape[2] * shape[3]
            v = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif leaf == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("running_mean", "bias") or k == "logit_scale":
            v = rng.randn(*shape) * 0.05 if shape else np.log(100.0)
        elif leaf == "weight" and len(shape) == 1:   # BN or LayerNorm scale
            last = ".bn3." in k or ".downsample.1." in k
            v = rng.uniform(0.8, 1.2, shape) * (0.2 if last else 1.0)
        elif k == "token_embedding.weight":
            v = rng.randn(*shape) * 0.02
        elif k == "positional_embedding":
            v = rng.randn(*shape) * 0.01
        elif k.endswith("positional_embedding"):    # attnpool
            v = rng.randn(*shape) * shape[1] ** -0.5
        else:                                      # linears, projection
            v = rng.randn(*shape) * shape[-1 if len(shape) == 2
                                          and k != "text_projection"
                                          else 0] ** -0.5
        out[k] = np.asarray(v, np.float32)
    return out


def clip_assets(directory: str, class_names: Sequence[str], style: str,
                seed: int, **text) -> Tuple[str, str]:
    """A random checkpoint in OpenAI CLIP RN50's layout
    (:func:`random_clip_state_dict`; ``text`` may shrink its text
    transformer) and a BPE merges file that builds the words of the
    template prompts of ``class_names`` and background in ``style``,
    written into ``directory``: (checkpoint path, merges path)."""
    import os
    import re

    import torch

    from coin_tpu_torch.engine.clip_setup import PROMPT_TEMPLATES
    from coin_tpu_torch.models.tokenizer import write_bpe_merges
    sd = random_clip_state_dict(50, seed, **text)
    ckpt = os.path.join(directory, "RN50_random.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    prompts = " ".join(t.replace("{0}", style).replace("{1}", n)
                       for t in PROMPT_TEMPLATES
                       for n in list(class_names) + ["background"])
    bpe = os.path.join(directory, "bpe_random.txt.gz")
    write_bpe_merges(bpe, re.findall("[a-z]+", prompts.lower()) + ["x"])
    return ckpt, bpe


def swin_manifest(variant: str = "swinB", prefix: str = "backbone.0",
                  out_indices: Iterable[int] = (1, 2, 3)
                  ) -> Tuple[Dict[str, Shape], Set[str]]:
    """IDEA Swin backbone keys (qkv fused, PatchMerging reduction/norm,
    per-out-index norms)."""
    embed, depths, heads, window = _SWIN[variant]
    dims = [embed * (2 ** s) for s in range(len(depths))]
    keys: Dict[str, Shape] = {}
    bufs: Set[str] = set()
    keys[f"{prefix}.patch_embed.proj.weight"] = (embed, 3, 4, 4)
    keys[f"{prefix}.patch_embed.proj.bias"] = (embed,)
    _ln(keys, f"{prefix}.patch_embed.norm", embed)
    table = (2 * window - 1) ** 2
    for s, depth in enumerate(depths):
        d = dims[s]
        for b in range(depth):
            p = f"{prefix}.layers.{s}.blocks.{b}"
            _ln(keys, f"{p}.norm1", d)
            keys[f"{p}.attn.relative_position_bias_table"] = (table,
                                                              heads[s])
            bufs.add(f"{p}.attn.relative_position_index")
            _lin(keys, f"{p}.attn.qkv", 3 * d, d)
            _lin(keys, f"{p}.attn.proj", d, d)
            _ln(keys, f"{p}.norm2", d)
            _lin(keys, f"{p}.mlp.fc1", 4 * d, d)
            _lin(keys, f"{p}.mlp.fc2", d, 4 * d)
        if s < len(depths) - 1:
            p = f"{prefix}.layers.{s}.downsample"
            keys[f"{p}.reduction.weight"] = (2 * d, 4 * d)
            _ln(keys, f"{p}.norm", 4 * d)
    for s in out_indices:
        _ln(keys, f"{prefix}.norm{s}", dims[s])
    return keys, bufs


def _bert_layer(keys: Dict[str, Shape], p: str, hidden: int = 768,
                inter: int = 3072) -> None:
    """One HF BERT encoder layer."""
    for qkv in ("query", "key", "value"):
        _lin(keys, f"{p}.attention.self.{qkv}", hidden, hidden)
    _lin(keys, f"{p}.attention.output.dense", hidden, hidden)
    _ln(keys, f"{p}.attention.output.LayerNorm", hidden)
    _lin(keys, f"{p}.intermediate.dense", inter, hidden)
    _lin(keys, f"{p}.output.dense", hidden, inter)
    _ln(keys, f"{p}.output.LayerNorm", hidden)


def bert_manifest(prefix: str = "bert", layers: int = 12,
                  hidden: int = 768, vocab: int = 30522
                  ) -> Tuple[Dict[str, Shape], Set[str]]:
    """HF BertModel keys as they appear inside the GroundingDINO
    checkpoint (``bert.*``)."""
    keys: Dict[str, Shape] = {}
    bufs: Set[str] = {f"{prefix}.embeddings.position_ids"}
    inter = hidden * 4
    keys[f"{prefix}.embeddings.word_embeddings.weight"] = (vocab, hidden)
    keys[f"{prefix}.embeddings.position_embeddings.weight"] = (512, hidden)
    keys[f"{prefix}.embeddings.token_type_embeddings.weight"] = (2, hidden)
    _ln(keys, f"{prefix}.embeddings.LayerNorm", hidden)
    for i in range(layers):
        _bert_layer(keys, f"{prefix}.encoder.layer.{i}", hidden, inter)
    _lin(keys, f"{prefix}.pooler.dense", hidden, hidden)
    return keys, bufs


def gdino_manifest(variant: str = "swinB", enc_layers: int = 6,
                   dec_layers: int = 6, num_queries: int = 900,
                   bert_layers: int = 12, bert_vocab: int = 30522
                   ) -> Tuple[Dict[str, Shape], Set[str]]:
    """The full ``groundingdino_*.pth`` 'model' dict layout (after
    clean_state_dict strips 'module.'); ``bert_vocab`` below BERT-base's
    30 522 rows only for small test checkpoints."""
    d = 256                   # hidden_dim
    ffn, t_ffn = 2048, 1024   # image / text enhancer FFN dims
    heads, levels, points = 8, 4, 4
    fuse_embed = 1024         # BiMultiHeadAttention embed_dim

    keys, bufs = swin_manifest(variant)
    bk, bb = bert_manifest(layers=bert_layers, vocab=bert_vocab)
    keys.update(bk)
    bufs |= bb

    embed = _SWIN[variant][0]
    chans = [embed * 2, embed * 4, embed * 8]  # out_indices (1,2,3)

    _lin(keys, "feat_map", d, 768)
    for i in range(4):
        cin = chans[i] if i < 3 else chans[-1]
        k = 1 if i < 3 else 3
        keys[f"input_proj.{i}.0.weight"] = (d, cin, k, k)
        keys[f"input_proj.{i}.0.bias"] = (d,)
        _ln(keys, f"input_proj.{i}.1", d)  # GroupNorm(32, d)

    t = "transformer"
    keys[f"{t}.level_embed"] = (levels, d)
    keys[f"{t}.tgt_embed.weight"] = (num_queries, d)
    _lin(keys, f"{t}.enc_output", d, d)
    _ln(keys, f"{t}.enc_output_norm", d)
    for j, (o, i_) in enumerate(((d, d), (d, d), (4, d))):
        _lin(keys, f"{t}.enc_out_bbox_embed.layers.{j}", o, i_)

    def deform(p):
        _lin(keys, f"{p}.sampling_offsets", heads * levels * points * 2, d)
        _lin(keys, f"{p}.attention_weights", heads * levels * points, d)
        _lin(keys, f"{p}.value_proj", d, d)
        _lin(keys, f"{p}.output_proj", d, d)

    def mha(p):
        keys[f"{p}.in_proj_weight"] = (3 * d, d)
        keys[f"{p}.in_proj_bias"] = (3 * d,)
        _lin(keys, f"{p}.out_proj", d, d)

    for i in range(enc_layers):
        p = f"{t}.encoder.layers.{i}"           # image (deformable)
        deform(f"{p}.self_attn")
        _ln(keys, f"{p}.norm1", d)
        _lin(keys, f"{p}.linear1", ffn, d)
        _lin(keys, f"{p}.linear2", d, ffn)
        _ln(keys, f"{p}.norm2", d)
        p = f"{t}.encoder.text_layers.{i}"      # text enhancer
        mha(f"{p}.self_attn")
        _ln(keys, f"{p}.norm1", d)
        _lin(keys, f"{p}.linear1", t_ffn, d)
        _lin(keys, f"{p}.linear2", d, t_ffn)
        _ln(keys, f"{p}.norm2", d)
        p = f"{t}.encoder.fusion_layers.{i}"    # BiAttentionBlock
        keys[f"{p}.gamma_v"] = (d,)
        keys[f"{p}.gamma_l"] = (d,)
        _ln(keys, f"{p}.layer_norm_v", d)
        _ln(keys, f"{p}.layer_norm_l", d)
        for proj in ("v_proj", "l_proj", "values_v_proj",
                     "values_l_proj"):
            _lin(keys, f"{p}.attn.{proj}", fuse_embed, d)
        for proj in ("out_v_proj", "out_l_proj"):
            _lin(keys, f"{p}.attn.{proj}", d, fuse_embed)

    for i in range(dec_layers):
        p = f"{t}.decoder.layers.{i}"
        deform(f"{p}.cross_attn")
        _ln(keys, f"{p}.norm1", d)
        mha(f"{p}.ca_text")
        _ln(keys, f"{p}.catext_norm", d)
        mha(f"{p}.self_attn")
        _ln(keys, f"{p}.norm2", d)
        _lin(keys, f"{p}.linear1", ffn, d)
        _lin(keys, f"{p}.linear2", d, ffn)
        _ln(keys, f"{p}.norm3", d)
        for j, (o, i_) in enumerate(((d, d), (d, d), (4, d))):
            _lin(keys, f"bbox_embed.{i}.layers.{j}", o, i_)

    _ln(keys, f"{t}.decoder.norm", d)
    for j, (o, i_) in enumerate(((d, 2 * d), (d, d))):
        _lin(keys, f"{t}.decoder.ref_point_head.layers.{j}", o, i_)
    return keys, bufs


def glip_manifest(variant: str = "swinL", num_blocks: int = 8,
                  num_classes: int = 80, bert_layers: int = 12,
                  bert_vocab: int = 30522
                  ) -> Tuple[Dict[str, Shape], Set[str]]:
    """The official ``glip_large_model.pth`` / ``glip_tiny_*.pth`` 'model'
    dict layout (coin_tpu/models/manifests.py:306): Swin under
    ``backbone.body``, the FPN with RetinaNet ``top_blocks.{p6,p7}``, BERT
    under ``language_backbone.body.model``, and the dyhead tower, whose
    conv block i interleaves three modules: ``dyhead_tower.{3i}`` VLFuse
    (``b_attn``, embed 2048, v_dim 256, l_dim 768), ``{3i+1}`` a BERT
    encoder layer, ``{3i+2}`` DyConv (three deformable convs with
    GroupNorm(16), the shared ``offset`` net, ``AttnConv`` and DYReLU's
    ``relu.fc``). The head's ``cls_logits`` is listed though the
    token-based inference never reads it. ``bert_layers`` and
    ``bert_vocab`` below BERT-base's only for small test checkpoints."""
    d = 256                    # DYHEAD.CHANNELS
    lang = 768
    fuse_embed = 2048          # FUSE_CONFIG MHA-B embed dim
    keys, bufs = swin_manifest(variant, prefix="backbone.body")
    bk, bb = bert_manifest(prefix="language_backbone.body.model",
                           layers=bert_layers, vocab=bert_vocab)
    keys.update(bk)
    bufs |= bb

    embed = _SWIN[variant][0]
    chans = {2: embed * 2, 3: embed * 4, 4: embed * 8}
    for idx in (2, 3, 4):
        keys[f"backbone.fpn.fpn_inner{idx}.weight"] = (d, chans[idx], 1, 1)
        keys[f"backbone.fpn.fpn_inner{idx}.bias"] = (d,)
        keys[f"backbone.fpn.fpn_layer{idx}.weight"] = (d, d, 3, 3)
        keys[f"backbone.fpn.fpn_layer{idx}.bias"] = (d,)
    for p67 in ("p6", "p7"):
        keys[f"backbone.fpn.top_blocks.{p67}.weight"] = (d, d, 3, 3)
        keys[f"backbone.fpn.top_blocks.{p67}.bias"] = (d,)

    tower = "rpn.head.dyhead_tower"
    for i in range(num_blocks):
        p = f"{tower}.{3 * i}.b_attn"
        keys[f"{p}.gamma_v"] = (d,)
        keys[f"{p}.gamma_l"] = (lang,)
        _ln(keys, f"{p}.layer_norm_v", d)
        _ln(keys, f"{p}.layer_norm_l", lang)
        for proj, i_ in (("v_proj", d), ("l_proj", lang),
                         ("values_v_proj", d), ("values_l_proj", lang)):
            _lin(keys, f"{p}.attn.{proj}", fuse_embed, i_)
        _lin(keys, f"{p}.attn.out_v_proj", d, fuse_embed)
        _lin(keys, f"{p}.attn.out_l_proj", lang, fuse_embed)
        _bert_layer(keys, f"{tower}.{3 * i + 1}")
        p = f"{tower}.{3 * i + 2}"
        for j in range(3):
            keys[f"{p}.DyConv.{j}.conv.weight"] = (d, d, 3, 3)
            keys[f"{p}.DyConv.{j}.conv.bias"] = (d,)
            _ln(keys, f"{p}.DyConv.{j}.bn", d)      # GroupNorm(16, d)
        keys[f"{p}.offset.weight"] = (27, d, 3, 3)
        keys[f"{p}.offset.bias"] = (27,)
        keys[f"{p}.AttnConv.1.weight"] = (1, d, 1, 1)
        keys[f"{p}.AttnConv.1.bias"] = (1,)
        _lin(keys, f"{p}.relu.fc.0", d // 4, d)
        _lin(keys, f"{p}.relu.fc.2", 4 * d, d // 4)

    head = "rpn.head"
    keys[f"{head}.cls_logits.weight"] = (num_classes, d, 1, 1)
    keys[f"{head}.cls_logits.bias"] = (num_classes,)
    keys[f"{head}.bbox_pred.weight"] = (4, d, 1, 1)
    keys[f"{head}.bbox_pred.bias"] = (4,)
    keys[f"{head}.centerness.weight"] = (1, d, 1, 1)
    keys[f"{head}.centerness.bias"] = (1,)
    _lin(keys, f"{head}.dot_product_projection_text", d, lang)
    keys[f"{head}.log_scale"] = (1,)
    keys[f"{head}.bias_lang"] = (lang,)
    keys[f"{head}.bias0"] = (1,)
    for s in range(5):
        keys[f"{head}.scales.{s}.scale"] = (1,)
    return keys, bufs


def synth_state_dict(keys: Dict[str, Shape], seed: int = 0
                     ) -> Dict[str, np.ndarray]:
    """A random checkpoint with exactly the manifest's params (numpy,
    N(0, 0.02²))."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in keys.items():
        out[k] = (np.asarray(rng.randn(*s)) * 0.02).astype(np.float32)
    return out


def diff_keys(actual: Iterable[str], manifest_keys: Dict[str, Shape],
              manifest_bufs: Set[str]) -> Dict[str, list]:
    """A checkpoint's key set against a manifest: {'missing': [...],
    'unexpected': [...]}."""
    actual = set(actual)
    expected = set(manifest_keys) | set(manifest_bufs)
    return {"missing": sorted(expected - actual),
            "unexpected": sorted(actual - expected)}
