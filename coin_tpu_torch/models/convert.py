"""OpenAI CLIP checkpoint → the port's modules (counterpart of
coin_tpu/models/convert.py).

The user supplies the torch archive of CLIP RN50 (TorchScript or a plain
state dict; zero-egress environments cannot download it). The maps below
rename its tensors into the ``state_dict`` names of the port's
``CLIPResNetBackbone``, ``Res5Head``, ``AttentionPool2d`` and
``TextTransformer``. Both sides keep torch's layouts (OIHW convs, (out,
in) linears), so nothing is transposed: the attention's packed
``in_proj`` splits into the query, key and value linears, and a
bottleneck's ``downsample.0`` / ``downsample.1`` become
``downsample_conv`` / ``downsample_bn``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> StateDict:
    """Every tensor of a TorchScript archive (tried first) or of a
    ``torch.save``d state dict (under ``"model"`` if it is there), as f32
    on the CPU."""
    try:
        sd = torch.jit.load(path, map_location="cpu").eval().state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu")
        if "model" in sd and isinstance(sd["model"], dict):
            sd = sd["model"]
    return {k: v.detach().float().cpu() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def _bn(sd: StateDict, src: str, dst: str) -> StateDict:
    return {f"{dst}.{leaf}": sd[f"{src}.{leaf}"]
            for leaf in ("weight", "bias", "running_mean", "running_var")}


def _bottleneck(sd: StateDict, src: str, dst: str) -> StateDict:
    out: StateDict = {}
    for i in (1, 2, 3):
        out[f"{dst}.conv{i}.weight"] = sd[f"{src}.conv{i}.weight"]
        out.update(_bn(sd, f"{src}.bn{i}", f"{dst}.bn{i}"))
    if f"{src}.downsample.0.weight" in sd:
        out[f"{dst}.downsample_conv.weight"] = sd[f"{src}.downsample.0.weight"]
        out.update(_bn(sd, f"{src}.downsample.1", f"{dst}.downsample_bn"))
    return out


def _stage(sd: StateDict, src: str, dst: str, blocks: int) -> StateDict:
    out: StateDict = {}
    for i in range(blocks):
        out.update(_bottleneck(sd, f"{src}.{i}", f"{dst}.{i}"))
    return out


def convert_clip_visual(sd: StateDict, layers: Sequence[int] = (3, 4, 6, 3)
                        ) -> Tuple[StateDict, StateDict, Optional[StateDict]]:
    """(backbone, res5, attnpool) state dicts of CLIP's ``visual.*``
    tensors; attnpool is None when the checkpoint has none."""
    v = "visual"
    backbone: StateDict = {}
    for i in (1, 2, 3):
        backbone[f"conv{i}.weight"] = sd[f"{v}.conv{i}.weight"]
        backbone.update(_bn(sd, f"{v}.bn{i}", f"bn{i}"))
    for i in (1, 2, 3):
        backbone.update(_stage(sd, f"{v}.layer{i}", f"layer{i}",
                               layers[i - 1]))
    res5 = _stage(sd, f"{v}.layer4", "layer4", layers[3])
    ap = f"{v}.attnpool"
    if f"{ap}.positional_embedding" not in sd:
        return backbone, res5, None
    attnpool = {"positional_embedding": sd[f"{ap}.positional_embedding"]}
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        for leaf in ("weight", "bias"):
            attnpool[f"{proj}.{leaf}"] = sd[f"{ap}.{proj}.{leaf}"]
    return backbone, res5, attnpool


def text_geometry(sd: StateDict) -> Dict[str, int]:
    """The text trunk a checkpoint holds: width, heads (width / 64, as the
    JAX converter splits them), layers, embed_dim, vocab and context."""
    width = sd["ln_final.weight"].shape[0]
    return dict(
        width=width, heads=max(1, width // 64),
        layers=len({k.split(".")[2] for k in sd
                    if k.startswith("transformer.resblocks.")}),
        embed_dim=sd["text_projection"].shape[1],
        vocab_size=sd["token_embedding.weight"].shape[0],
        context_length=sd["positional_embedding"].shape[0])


def convert_clip_text(sd: StateDict) -> StateDict:
    """The ``TextTransformer`` state dict of a CLIP checkpoint."""
    out: StateDict = {
        "token_embedding.weight": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "ln_final.weight": sd["ln_final.weight"],
        "ln_final.bias": sd["ln_final.bias"],
        "text_projection": sd["text_projection"],
    }
    for i in range(text_geometry(sd)["layers"]):
        p, q = f"transformer.resblocks.{i}", f"resblock_{i}"
        w = sd[f"{p}.attn.in_proj_weight"].chunk(3, dim=0)
        b = sd[f"{p}.attn.in_proj_bias"].chunk(3, dim=0)
        for name, wi, bi in zip(("query", "key", "value"), w, b):
            out[f"{q}.attn.{name}.weight"] = wi.contiguous()
            out[f"{q}.attn.{name}.bias"] = bi.contiguous()
        out[f"{q}.attn.out.weight"] = sd[f"{p}.attn.out_proj.weight"]
        out[f"{q}.attn.out.bias"] = sd[f"{p}.attn.out_proj.bias"]
        for ln in ("ln_1", "ln_2"):
            out[f"{q}.{ln}.weight"] = sd[f"{p}.{ln}.weight"]
            out[f"{q}.{ln}.bias"] = sd[f"{p}.{ln}.bias"]
        for mlp in ("c_fc", "c_proj"):
            out[f"{q}.mlp_{mlp}.weight"] = sd[f"{p}.mlp.{mlp}.weight"]
            out[f"{q}.mlp_{mlp}.bias"] = sd[f"{p}.mlp.{mlp}.bias"]
    return out


def logit_scale_from(sd: StateDict) -> float:
    return float(sd["logit_scale"])
