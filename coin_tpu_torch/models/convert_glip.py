"""Official GLIP checkpoint → the port's state dicts (counterpart of
coin_tpu/models/convert_glip.py).

Maps ``glip_large_model.pth`` / ``glip_tiny_*.pth`` (microsoft/GLIP's
maskrcnn_benchmark fork) straight into the ``state_dict`` of
``models/glip.GLIP`` and, through ``convert_gdino.bert_state_dict`` with
the ``language_backbone.body.model.`` prefix, of ``models/bert.BertModel``.
Both sides are torch, so weights keep their (out, in) and OIHW layouts;
names change, the DyConv branches take the official order (``DyConv.0``
runs on the coarser level: high; ``.1`` on the same level: mid; ``.2`` at
stride 2 on the finer level: low; coin_tpu/models/convert_glip.py:97-104),
``AttnConv.1``'s 1×1 conv becomes a dense layer, the one-element
``bias0`` and ``log_scale`` become scalars and the per-level
``scales.{s}.scale`` one vector. ``rpn.head.cls_logits`` (trained, never
read by the token-based inference) is left out. The checkpoint's key set
is first held to ``models/manifests.glip_manifest`` of its own geometry.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from coin_tpu_torch.models.convert_gdino import (_count, _tensor,
                                                 check_keys,
                                                 clean_state_dict,
                                                 swin_rules)
from coin_tpu_torch.models.manifests import glip_manifest

TOWER = "rpn.head.dyhead_tower."
BERT_PREFIX = "language_backbone.body.model."

_RULES = swin_rules("backbone.body") + (
    (r"backbone\.fpn\.fpn_(inner|layer)(\d)\.", r"fpn.fpn_\1\2."),
    (r"backbone\.fpn\.top_blocks\.(p6|p7)\.", r"fpn.top_\1."),
    (r"rpn\.head\.(bbox_pred|centerness|dot_product_projection_text)\.",
     r"head.\1."),
    (r"rpn\.head\.bias_lang$", "head.bias_lang"),
)
# the three tower modules of block i: 3i VLFuse, 3i+1 BERT layer,
# 3i+2 DyConv
_TOWER_RULES = (
    (
        (r"b_attn\.attn\.", "fusion_attn."),
        (r"b_attn\.layer_norm_(v|l)\.", r"fusion_layer_norm_\1."),
        (r"b_attn\.gamma_(v|l)$", r"fusion_gamma_\1"),
    ), (
        (r"attention\.self\.(query|key|value)\.", r"lang_layer.\1."),
        (r"attention\.output\.dense\.", "lang_layer.att_out."),
        (r"attention\.output\.LayerNorm\.", "lang_layer.att_ln."),
        (r"intermediate\.dense\.", "lang_layer.inter."),
        (r"output\.dense\.", "lang_layer.out."),
        (r"output\.LayerNorm\.", "lang_layer.out_ln."),
    ), (
        (r"DyConv\.0\.conv\.", "dyconv_high."),
        (r"DyConv\.1\.conv\.", "dyconv_mid."),
        (r"DyConv\.2\.conv\.", "dyconv_low."),
        (r"DyConv\.0\.bn\.", "dyconv_high.gn."),
        (r"DyConv\.1\.bn\.", "dyconv_mid.gn."),
        (r"DyConv\.2\.bn\.", "dyconv_low.gn."),
        (r"offset\.", "dyconv_offset."),
        (r"AttnConv\.1\.", "scale_attn_fc."),
        (r"relu\.fc\.0\.", "dyrelu.fc1."),
        (r"relu\.fc\.2\.", "dyrelu.fc2."),
    ),
)


def glip_geometry(sd: Dict[str, Any]) -> Dict[str, int]:
    """Tower blocks (three tower slots each), head classes, BERT layers
    and vocabulary rows of a cleaned checkpoint."""
    slots = [int(k[len(TOWER):].split(".")[0]) for k in sd
             if k.startswith(TOWER)]
    return dict(
        num_blocks=1 + max(slots, default=23) // 3,
        num_classes=int(np.shape(sd["rpn.head.cls_logits.weight"])[0]),
        bert_layers=_count(sd, re.escape(BERT_PREFIX)
                           + r"encoder\.layer\.(\d+)\."),
        bert_vocab=int(np.shape(
            sd[BERT_PREFIX + "embeddings.word_embeddings.weight"])[0]))


def _rename(key: str) -> str:
    if key.startswith(TOWER):
        slot, rest = key[len(TOWER):].split(".", 1)
        block, kind = divmod(int(slot), 3)
        for pattern, repl in _TOWER_RULES[kind]:
            new, n = re.subn("^" + pattern, repl, rest)
            if n:
                return f"dyhead_{block}.{new}"
        raise KeyError(key)
    for pattern, repl in _RULES:
        new, n = re.subn("^" + pattern, repl, key)
        if n:
            return new
    raise KeyError(key)


def convert_glip(sd: Dict[str, Any], variant: str = "swinL"
                 ) -> Dict[str, torch.Tensor]:
    """The GLIP ``state_dict`` of the port from an official checkpoint
    (BERT apart: ``bert_state_dict(sd, prefix=BERT_PREFIX)``); the tower
    depth is the checkpoint's."""
    sd = clean_state_dict(sd)
    keys, bufs = glip_manifest(variant, **glip_geometry(sd))
    check_keys(sd, f"{variant} GLIP", keys, bufs)
    out: Dict[str, torch.Tensor] = {}
    scales = {}
    for key, value in sd.items():
        if (key.startswith(BERT_PREFIX) or key in bufs
                or key.startswith("rpn.head.cls_logits.")):
            continue
        v = _tensor(value)
        m = re.match(r"rpn\.head\.scales\.(\d+)\.scale$", key)
        if m:
            scales[int(m.group(1))] = v.reshape(())
        elif key in ("rpn.head.bias0", "rpn.head.log_scale"):
            out["head." + key.rsplit(".", 1)[1]] = v.reshape(())
        else:
            name = _rename(key)
            if name.endswith("scale_attn_fc.weight"):
                v = v.reshape(v.shape[0], v.shape[1])   # (1, C, 1, 1)
            out[name] = v
    out["head.scales"] = torch.stack([scales[s] for s in sorted(scales)])
    return out
