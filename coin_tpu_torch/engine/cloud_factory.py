"""Cloud-teacher construction from user-supplied checkpoints
(counterpart of coin_tpu/engine/cloud_factory.py): the GroundingDINO
detector and its class-only variant, the GLIP detector, plus the
zero-asset stand-ins that pipeline rehearsals and tests use, and the
CLIP re-scorer (``build_clip_scorer``). The GDINO-1.5-API teacher (it
needs the network) raises.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
from torch import nn

from coin_tpu_torch.data.augment import normalize_batch
from coin_tpu_torch.device import resolve_device
from coin_tpu_torch.engine.clip_setup import template_prototypes
from coin_tpu_torch.models.clip_resnet import DEPTH_CFG
from coin_tpu_torch.models.clip_scorer import CLIPScorer
from coin_tpu_torch.models.convert import (convert_clip_text,
                                           convert_clip_visual,
                                           load_torch_state_dict,
                                           logit_scale_from, text_geometry)
from coin_tpu_torch.models.convert_gdino import (bert_model,
                                                 clean_state_dict,
                                                 convert_gdino)
from coin_tpu_torch.models.convert_glip import (BERT_PREFIX, convert_glip,
                                                glip_geometry)
from coin_tpu_torch.models.gdino import GroundingDINO
from coin_tpu_torch.models.gdino_detector import GDINODetector
from coin_tpu_torch.models.gdino_variants import (ClassOnlyAdapter,
                                                  GDINO15APIDetector)
from coin_tpu_torch.models.glip import GLIP
from coin_tpu_torch.models.glip_detector import GLIPDetector
from coin_tpu_torch.models.text_encoder import TextTransformer
from coin_tpu_torch.models.tokenizer import ClipTokenizer
from coin_tpu_torch.models.wordpiece import WordPieceTokenizer


class _TableBert(nn.Module):
    """A stand-in for BERT: a fixed 64 × 768 lookup table."""

    def __init__(self, table: np.ndarray):
        super().__init__()
        self.table = nn.Parameter(torch.from_numpy(table),
                                  requires_grad=False)

    def forward(self, ids, mask):
        return self.table[ids.clamp(0, self.table.shape[0] - 1)]


def build_synthetic_detector(class_names, device="cuda"):
    """A random-weight tiny GroundingDINO (swinT, 64 queries, one encoder
    and one decoder layer, a lookup table for BERT) through the real
    collection machinery: tokenize, embed, forward, post-process.
    Detections are meaningless; it needs no asset."""
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "."]
    for name in class_names:
        words += name.lower().split()
    with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                     delete=False) as vocab:
        vocab.write("\n".join(dict.fromkeys(words)) + "\n")
    tok = WordPieceTokenizer(vocab.name)
    os.unlink(vocab.name)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = GroundingDINO(variant="swinT", num_queries=64, enc_layers=1,
                              dec_layers=1)
        for name, p in model.named_parameters():
            if name in ("level_embed", "tgt_embed"):
                nn.init.normal_(p)
            elif name.endswith("relative_position_bias_table"):
                nn.init.trunc_normal_(p, std=0.02)
    table = (np.random.RandomState(0).randn(64, 768) * 0.1).astype(np.float32)
    return GDINODetector(model, _TableBert(table), class_names, tok,
                         threshold=0.0, capacity=64, device=device)


def build_stub_scorer(num_classes):
    """Softmax over seeded random logits: stands in for the CLIP scorer in
    --synthetic-teacher rehearsals (the same logits at every call)."""

    def scorer_apply(images_u8, boxes):
        b, n, _ = boxes.shape
        g = torch.Generator().manual_seed(1)
        logits = torch.randn((b, n, num_classes + 1), generator=g)
        return torch.softmax(logits, dim=-1).to(boxes.device)

    return scorer_apply


def _checkpoint_and_vocab(cfg, what: str):
    """The cleaned MODEL.TEACHER_CLOUD.WEIGHT state dict and the
    TPU.BERT_VOCAB path; raises if either file is missing."""
    weight = cfg.MODEL.TEACHER_CLOUD.WEIGHT
    vocab = cfg.get_path("TPU.BERT_VOCAB", "")
    if not (weight and os.path.exists(weight)):
        raise FileNotFoundError(
            f"{what} checkpoint not found: {weight!r} "
            "(set MODEL.TEACHER_CLOUD.WEIGHT)")
    if not (vocab and os.path.exists(vocab)):
        raise FileNotFoundError(
            "BERT vocab.txt not found (set TPU.BERT_VOCAB)")
    sd = torch.load(weight, map_location="cpu")
    return clean_state_dict(sd.get("model", sd)), vocab


def build_cloud_detector(cfg, arch, class_names, device="cuda",
                         dtype: torch.dtype = torch.bfloat16):
    """The cloud teacher of ``arch`` from MODEL.TEACHER_CLOUD.WEIGHT and
    TPU.BERT_VOCAB, on ``device``. GroundingDINO and GLIP compute in
    ``dtype`` over f32 parameters (bf16, as the JAX package builds them;
    GLIP's DyConv stays in f32) with the BERT in f32.
    GroundingDINO: TPU.GDINO_ENC_LAYERS / GDINO_DEC_LAYERS cut the towers,
    and the number of queries comes from the checkpoint. GLIP
    (MODEL.TEACHER_CLOUD.TYPE swinL or swinT): the number of VLDyHead
    blocks comes from the checkpoint."""
    device = resolve_device(device)
    tc = cfg.MODEL.TEACHER_CLOUD
    if arch in ("GDINO", "GDINO_CLASSONLY"):
        sd, vocab = _checkpoint_and_vocab(cfg, "GDINO")
        variant = tc.TYPE
        enc = cfg.get_path("TPU.GDINO_ENC_LAYERS", 6)
        dec = cfg.get_path("TPU.GDINO_DEC_LAYERS", 6)
        nq = sd["transformer.tgt_embed.weight"].shape[0]
        model = GroundingDINO(variant=variant, num_queries=nq,
                              enc_layers=enc, dec_layers=dec, dtype=dtype)
        model.load_state_dict(convert_gdino(sd, variant, enc, dec),
                              strict=True)
        bert = bert_model(sd, "bert.")
        del sd
        det = GDINODetector(
            model, bert, class_names, WordPieceTokenizer(vocab),
            threshold=tc.TEST_THRESHOLD,
            per_class_test=tc.get("PER_CLASS_TEST", False),
            type_filter=tc.get("USE_DINO_TYPE_FILTER", False), device=device)
        if arch == "GDINO_CLASSONLY":
            det = ClassOnlyAdapter(det, len(class_names))
        return det
    if arch in ("GLIP", "GLIPModel"):
        sd, vocab = _checkpoint_and_vocab(cfg, "GLIP")
        model = GLIP(variant=tc.TYPE,
                     num_blocks=glip_geometry(sd)["num_blocks"], dtype=dtype)
        model.load_state_dict(convert_glip(sd, tc.TYPE), strict=True)
        bert = bert_model(sd, BERT_PREFIX)
        del sd
        return GLIPDetector(model, bert, class_names,
                            WordPieceTokenizer(vocab),
                            threshold=tc.TEST_THRESHOLD, device=device)
    if arch == "GDINO1_5_API":
        return GDINO15APIDetector(tc.get("TOKEN", ""), class_names)
    raise ValueError(f"unsupported cloud architecture: {arch}")


def build_clip_scorer(cfg, class_names, device="cuda"):
    """The CLIP re-scorer of the collection stage: ``scorer_apply(images_u8
    (B, H, W, 3), boxes (B, N, 4)) -> probs (B, N, C+1)`` on ``device``.
    TPU.CLIP_WEIGHTS (OpenAI CLIP's torch archive) gives the visual tower,
    which computes in bf16 over f32 parameters (the attention pool in
    f32), and the text trunk, which computes the frozen template-mean
    prototypes of the classes and background in f32 (style
    DATASETS.STYLE_NAME) once here; TPU.CLIP_BPE_VOCAB is the tokenizer's
    merges file. The images are CLIP-normalised first (K4n on the card)."""
    device = resolve_device(device)
    clip_path = cfg.get_path("TPU.CLIP_WEIGHTS", "")
    vocab = cfg.get_path("TPU.CLIP_BPE_VOCAB", "")
    if not (clip_path and os.path.exists(clip_path)):
        raise FileNotFoundError("TPU.CLIP_WEIGHTS missing for re-scoring")
    if not (vocab and os.path.exists(vocab)):
        raise FileNotFoundError("TPU.CLIP_BPE_VOCAB missing for re-scoring")
    depth = cfg.MODEL.RESNETS.DEPTH
    sd = load_torch_state_dict(clip_path)
    backbone, res5, attnpool = convert_clip_visual(
        sd, DEPTH_CFG[depth]["layers"])
    scorer = CLIPScorer(depth, compute_dtype=torch.bfloat16)
    scorer.backbone.load_state_dict(backbone, strict=True)
    scorer.res5.load_state_dict(res5, strict=True)
    scorer.attnpool.load_state_dict(attnpool, strict=True)
    scorer = scorer.to(device).eval()
    if device.type == "cuda":
        scorer = scorer.to(memory_format=torch.channels_last)
    logit_scale = logit_scale_from(sd)

    # frozen text features: template-mean prototypes incl. background
    trunk = TextTransformer(**text_geometry(sd))
    trunk.load_state_dict(convert_clip_text(sd), strict=True)
    trunk = trunk.to(device).eval()
    del sd
    names = list(class_names) + ["background"]
    proto = template_prototypes(lambda t: trunk(t.to(device)),
                                ClipTokenizer(vocab), names,
                                cfg.DATASETS.STYLE_NAME or "realistic")
    text_features = torch.as_tensor(proto, dtype=torch.float32,
                                    device=device)

    @torch.no_grad()
    def scorer_apply(images_u8, boxes):
        return scorer(normalize_batch(images_u8), boxes, text_features,
                      logit_scale)

    return scorer_apply
