"""Official Grounding DINO checkpoint → the port's state dicts
(counterpart of coin_tpu/models/convert_gdino.py).

Maps ``groundingdino_swin{b,t}_*.pth`` straight into the ``state_dict``
of ``models/gdino.GroundingDINO`` (Swin, input projections, enhancer,
decoder) and of ``models/bert.BertModel`` (the ``bert.*`` keys). Both
sides are torch, so weights keep their (out, in) and OIHW layouts; only
names change, and ``nn.MultiheadAttention``'s packed ``in_proj`` splits
into the port's q, k and v. The checkpoint's key set is first held to
``models/manifests.gdino_manifest`` of its own geometry: a missing or an
unexpected key raises with ``diff_keys``' lists. A model with fewer
encoder or decoder layers than the checkpoint takes the first ones.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from coin_tpu_torch.models.bert import BertConfig, infer_bert_config
from coin_tpu_torch.models.manifests import diff_keys, gdino_manifest

# official name → port name, first match wins; \1... are kept groups
_RULES = (
    (r"backbone\.0\.patch_embed\.proj\.", "backbone.patch_embed_proj."),
    (r"backbone\.0\.patch_embed\.norm\.", "backbone.patch_embed_norm."),
    (r"backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.mlp\.fc(\d)\.",
     r"backbone.layers_\1_blocks_\2.mlp_fc\3."),
    (r"backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.",
     r"backbone.layers_\1_blocks_\2."),
    (r"backbone\.0\.layers\.(\d+)\.downsample\.",
     r"backbone.layers_\1_downsample."),
    (r"backbone\.0\.norm(\d+)\.", r"backbone.out_norm_\1."),
    (r"input_proj\.(\d)\.0\.", r"input_proj_\1_conv."),
    (r"input_proj\.(\d)\.1\.", r"input_proj_\1_gn."),
    (r"transformer\.level_embed$", "level_embed"),
    (r"transformer\.tgt_embed\.weight$", "tgt_embed"),
    (r"transformer\.enc_out_bbox_embed\.layers\.(\d)\.",
     r"enc_out_bbox_embed.layers_\1."),
    (r"transformer\.enc_output(_norm)?\.", r"enc_output\1."),
    (r"transformer\.decoder\.norm\.", "decoder_norm."),
    (r"transformer\.decoder\.ref_point_head\.layers\.(\d)\.",
     r"ref_point_head.layers_\1."),
    (r"transformer\.encoder\.layers\.(\d+)\.", r"enc_layer_\1."),
    (r"transformer\.encoder\.text_layers\.(\d+)\.", r"text_layer_\1."),
    (r"transformer\.encoder\.fusion_layers\.(\d+)\.", r"fusion_\1."),
    (r"transformer\.decoder\.layers\.(\d+)\.", r"dec_layer_\1."),
    (r"bbox_embed\.(\d+)\.layers\.(\d)\.", r"bbox_embed_\1.layers_\2."),
    (r"feat_map\.", "feat_map."),
)
_LAYER = re.compile(r"^(enc_layer|text_layer|fusion|dec_layer|bbox_embed)_"
                    r"(\d+)\.")


def clean_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Strip the ``module.`` prefix of a DataParallel checkpoint."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().float()
    return torch.from_numpy(np.asarray(v, np.float32))


def _count(sd, pattern: str) -> int:
    rx = re.compile(pattern)
    return len({m.group(1) for k in sd for m in [rx.match(k)] if m})


def checkpoint_geometry(sd: Dict[str, Any]) -> Dict[str, int]:
    """Encoder, decoder and BERT layers, queries and BERT vocabulary rows
    of a cleaned checkpoint."""
    return dict(
        enc_layers=_count(sd, r"transformer\.encoder\.layers\.(\d+)\."),
        dec_layers=_count(sd, r"transformer\.decoder\.layers\.(\d+)\."),
        num_queries=int(np.shape(sd["transformer.tgt_embed.weight"])[0]),
        bert_layers=_count(sd, r"bert\.encoder\.layer\.(\d+)\."),
        bert_vocab=int(np.shape(
            sd["bert.embeddings.word_embeddings.weight"])[0]))


def _check_keys(sd: Dict[str, Any], variant: str, keys, bufs) -> None:
    """Raise unless ``sd`` has exactly the manifest's keys (buffers may be
    present or not)."""
    diff = diff_keys(sd, keys, set())
    diff["unexpected"] = [k for k in diff["unexpected"] if k not in bufs]
    if diff["missing"] or diff["unexpected"]:
        raise ValueError(
            f"not a {variant} GroundingDINO checkpoint: missing "
            f"{diff['missing'][:20]} ({len(diff['missing'])}), unexpected "
            f"{diff['unexpected'][:20]} ({len(diff['unexpected'])})")


def _rename(key: str) -> str:
    for pattern, repl in _RULES:
        new, n = re.subn("^" + pattern, repl, key)
        if n:
            return new
    raise KeyError(key)


def convert_gdino(sd: Dict[str, Any], variant: str = "swinB",
                  enc_layers: int = 6, dec_layers: int = 6
                  ) -> Dict[str, torch.Tensor]:
    """The GroundingDINO ``state_dict`` of the port from an official
    checkpoint (BERT apart: :func:`bert_state_dict`)."""
    sd = clean_state_dict(sd)
    keys, bufs = gdino_manifest(variant, **checkpoint_geometry(sd))
    _check_keys(sd, variant, keys, bufs)
    keep = {"enc_layer": enc_layers, "text_layer": enc_layers,
            "fusion": enc_layers, "dec_layer": dec_layers,
            "bbox_embed": dec_layers}
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        if key.startswith("bert.") or key in bufs:
            continue
        name = _rename(key)
        m = _LAYER.match(name)
        if m and int(m.group(2)) >= keep[m.group(1)]:
            continue
        v = _tensor(value)
        if name.endswith(".in_proj_weight") or name.endswith(".in_proj_bias"):
            base, leaf = name.rsplit(".in_proj_", 1)
            for part, t in zip("qkv", torch.chunk(v, 3, dim=0)):
                out[f"{base}.{part}.{leaf}"] = t.contiguous()
            continue
        out[name] = v
    return out


def bert_state_dict(sd: Dict[str, Any], prefix: str = "bert."
                    ) -> Tuple[BertConfig, Dict[str, torch.Tensor]]:
    """The ``prefix``* keys of a checkpoint as a ``BertModel`` state dict,
    with its geometry inferred from the shapes."""
    sd = clean_state_dict(sd)
    bert = {k[len(prefix):]: _tensor(v) for k, v in sd.items()
            if k.startswith(prefix) and not k.endswith("position_ids")}
    return infer_bert_config(bert), bert
