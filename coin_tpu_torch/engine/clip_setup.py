"""CLIP assets (counterpart of coin_tpu/engine/clip_setup.py): tokenize the
class prompts, load OpenAI CLIP weights into the detector, compute the
template-mean prototypes.

Zero-egress environments supply the checkpoint and the BPE vocab as files
(cfg TPU.CLIP_WEIGHTS / TPU.CLIP_BPE_VOCAB). The JAX package's restacking
of the converted trees into its ``lax.scan`` layout (TPU.SCAN_BLOCKS) has
no counterpart: the port's stages are always unrolled.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from coin_tpu_torch.models import convert as C
from coin_tpu_torch.models.clip_resnet import DEPTH_CFG
from coin_tpu_torch.models.tokenizer import ClipTokenizer

logger = logging.getLogger(__name__)

# Style-conditioned prompt templates with the same structure as the
# reference's MODIFIED_REGION_CLIP_TEMPLATES (coin/modeling/utils.py:
# 415-497; derived from the public RegionCLIP prompt set): each takes
# ({style}, {class}).
PROMPT_TEMPLATES: List[str] = [
    "There is a {1} in the {0} scene.",
    "There is the {1} in the {0} scene.",
    "a photo of a {1} in the {0} scene.",
    "a photo of the {1} in the {0} scene.",
    "a photo of one {1} in the {0} scene.",
    "itap of a {1} in the {0} style.",
    "itap of my {1} in the {0} style.",
    "itap of the {1} in the {0} style.",
    "a photo of a {1} in the {0} style.",
    "a photo of my {1} in the {0} style.",
    "a photo of the {1} in the {0} style.",
    "a photo of many {1} in the {0} style.",
    "a good photo of a {1} in the {0} style.",
    "a good photo of the {1} in the {0} style.",
    "a bad photo of a {1} in the {0} style.",
    "a bad photo of the {1} in the {0} style.",
    "a photo of a nice {1} in the {0} style.",
    "a photo of the nice {1} in the {0} style.",
    "a photo of a cool {1} in the {0} style.",
    "a photo of the cool {1} in the {0} style.",
    "a photo of a weird {1} in the {0} style.",
    "a photo of the weird {1} in the {0} style.",
    "a photo of a small {1} in the {0} style.",
    "a photo of the small {1} in the {0} style.",
    "a photo of a large {1} in the {0} style.",
    "a photo of the large {1} in the {0} style.",
    "a photo of a clean {1} in the {0} style.",
    "a photo of the clean {1} in the {0} style.",
    "a photo of a dirty {1} in the {0} style.",
    "a photo of the dirty {1} in the {0} style.",
    "a bright photo of a {1} in the {0} style.",
    "a bright photo of the {1} in the {0} style.",
    "a dark photo of a {1} in the {0} style.",
    "a dark photo of the {1} in the {0} style.",
    "a photo of a hard to see {1} in the {0} style.",
    "a photo of the hard to see {1} in the {0} style.",
    "a low resolution photo of a {1} in the {0} style.",
    "a low resolution photo of the {1} in the {0} style.",
    "a cropped photo of a {1} in the {0} style.",
    "a cropped photo of the {1} in the {0} style.",
    "a close-up photo of a {1} in the {0} style.",
    "a close-up photo of the {1} in the {0} style.",
    "a jpeg corrupted photo of a {1} in the {0} style.",
    "a jpeg corrupted photo of the {1} in the {0} style.",
    "a blurry photo of a {1} in the {0} style.",
    "a blurry photo of the {1} in the {0} style.",
    "a pixelated photo of a {1} in the {0} style.",
    "a pixelated photo of the {1} in the {0} style.",
    "a black and white photo of the {1} in the {0} style.",
    "a black and white photo of a {1} in the {0} style.",
    "a plastic {1} in the {0} style.",
    "the plastic {1} in the {0} style.",
    "a toy {1} in the {0} style.",
    "the toy {1} in the {0} style.",
    "a plushie {1} in the {0} style.",
    "the plushie {1} in the {0} style.",
    "a cartoon {1} in the {0} style.",
    "the cartoon {1} in the {0} style.",
    "an embroidered {1} in the {0} style.",
    "the embroidered {1} in the {0} style.",
    "a painting of the {1} in the {0} style.",
    "a painting of a {1} in the {0} style.",
]


def build_class_tokens(class_names: Sequence[str], tokenizer: ClipTokenizer,
                       add_prompt_num: int = 4) -> np.ndarray:
    """Tokenized learnable-prompt rows 'a photo of a X..X {cls}.' per class
    incl. background (clip_text.py:281-291). One-word class names only."""
    for n in class_names:
        assert " " not in n, "only one-word class names are supported"
    ctx = " ".join(["X"] * add_prompt_num)
    prompts = [f"a photo of a {ctx} {n}." for n in class_names]
    return tokenizer.tokenize(prompts)


def template_prototypes(encode_text: Callable[[torch.Tensor], torch.Tensor],
                        tokenizer: ClipTokenizer,
                        class_names: Sequence[str], style: str,
                        batch: int = 64) -> np.ndarray:
    """Per-class prototype = mean text feature over the style templates
    (clip_text.py:262-279), L2-normalized. ``encode_text`` takes (n, 77)
    int64 token ids on the CPU and returns (n, D) features."""
    protos = []
    for name in class_names:
        texts = [t.replace("{0}", style).replace("{1}", name)
                 for t in PROMPT_TEMPLATES]
        tokens = torch.from_numpy(tokenizer.tokenize(texts)).long()
        feats = []
        with torch.no_grad():
            for s in range(0, len(tokens), batch):
                feats.append(encode_text(tokens[s:s + batch])
                             .float().cpu().numpy())
        protos.append(np.concatenate(feats, 0).mean(0))
    p = np.stack(protos)
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def clip_state_dict(clip_path: str, region_clip_path: str = ""
                    ) -> C.StateDict:
    """The OpenAI checkpoint's tensors; with ``region_clip_path``, the
    visual ('backbone.*') and text ('lang_encoder.*') tensors of a
    RegionCLIP checkpoint instead (MODEL.REGION_CLIP, clip_backbone.py:
    108-125 and clip_text.py:122-135), with the OpenAI logit_scale."""
    sd = C.load_torch_state_dict(clip_path)
    if not region_clip_path:
        return sd
    remapped = {}
    for k, v in C.load_torch_state_dict(region_clip_path).items():
        if k.startswith("backbone."):
            remapped["visual." + k[len("backbone."):]] = v
        elif k.startswith("lang_encoder."):
            remapped[k[len("lang_encoder."):]] = v
    remapped["logit_scale"] = sd["logit_scale"]
    return remapped


@torch.no_grad()
def load_clip_into_model(model: torch.nn.Module, clip_path: str,
                         depth: int = 50, region_clip_path: str = ""
                         ) -> Tuple[torch.nn.Module, float]:
    """Overwrite the backbone, res5, attnpool (when the model has one) and
    text_trunk tensors of ``model`` with converted CLIP weights, in place;
    returns (model, logit_scale). As in the JAX package, converted tensors
    the model lacks are skipped with a warning."""
    sd = clip_state_dict(clip_path, region_clip_path)
    backbone, res5, attnpool = C.convert_clip_visual(
        sd, DEPTH_CFG[depth]["layers"])
    trees = [(backbone, "backbone."), (res5, "res5."),
             (C.convert_clip_text(sd), "text_trunk.")]
    own = model.state_dict(keep_vars=True)
    if any(k.startswith("attnpool.") for k in own):
        trees.append((attnpool, "attnpool."))
    updates = {prefix + k: v for tree, prefix in trees
               for k, v in tree.items()}
    missing = [k for k in updates if k not in own]
    if missing:
        logger.warning("CLIP load: %d keys missing in model: %s...",
                       len(missing), missing[:5])
    for k, v in updates.items():
        if k in own:
            if own[k].shape != v.shape:
                raise ValueError(f"CLIP load: {k} is {tuple(v.shape)} in "
                                 f"the checkpoint, {tuple(own[k].shape)} "
                                 "in the model")
            own[k].copy_(v)
    logger.info("loaded %d CLIP tensors", len(updates) - len(missing))
    return model, C.logit_scale_from(sd)


def setup_clip_assets(cfg, class_names: Sequence[str]):
    """Returns (class_tokens, tokenizer) from config, or synthetic tokens
    and None when no vocab is configured."""
    vocab = cfg.get_path("TPU.CLIP_BPE_VOCAB", "")
    if not vocab:
        from coin_tpu_torch.engine.common import simple_class_tokens
        return simple_class_tokens(len(class_names) + 1), None
    tok = ClipTokenizer(vocab)
    names: List[str] = list(class_names)
    if names[-1] != "background":
        names = names + ["background"]
    return build_class_tokens(names, tok, cfg.CLOUD.ADD_PROMPT_NUM), tok
