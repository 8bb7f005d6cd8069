"""Official Grounding DINO checkpoint key manifests (the GDINO part of
coin_tpu/models/manifests.py, kept so that the port imports nothing of
coin_tpu).

Each manifest lists, key by key with shapes, the state dict of the
official model definitions: IDEA-Research/GroundingDINO's
``backbone/swin_transformer.py``, ``transformer.py``,
``fuse_modules.py`` and ``groundingdino.py``, plus HF ``BertModel`` under
``bert.`` (the ``groundingdino_swinb_cogcoor.pth`` layout). Tests and
``chip_smoke.py`` build random checkpoints from them
(:func:`synth_state_dict`), so ``models/convert_gdino`` is held to the
official key names, not to its own inverse. Buffers (non-parameter keys
of the official state dicts) are listed apart; converters ignore them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Set, Tuple

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
