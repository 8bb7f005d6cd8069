"""Cloud-teacher construction from user-supplied checkpoints
(counterpart of coin_tpu/engine/cloud_factory.py): the GroundingDINO
detector and its class-only variant, plus the zero-asset stand-ins that
pipeline rehearsals and tests use. The GLIP and GDINO-1.5-API teachers
(ROADMAP item 20) and the CLIP re-scorer (item 21) are not ported and
raise.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
from torch import nn

from coin_tpu_torch.device import resolve_device
from coin_tpu_torch.models.bert import BertModel
from coin_tpu_torch.models.convert_gdino import (bert_state_dict,
                                                 clean_state_dict,
                                                 convert_gdino)
from coin_tpu_torch.models.gdino import GroundingDINO
from coin_tpu_torch.models.gdino_detector import GDINODetector
from coin_tpu_torch.models.gdino_variants import (ClassOnlyAdapter,
                                                  GDINO15APIDetector)
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


def build_cloud_detector(cfg, arch, class_names, device="cuda",
                         dtype: torch.dtype = torch.bfloat16):
    """The cloud teacher of ``arch`` from MODEL.TEACHER_CLOUD.WEIGHT and
    TPU.BERT_VOCAB, on ``device``. GroundingDINO computes in ``dtype`` over
    f32 parameters (bf16, as the JAX package builds it) with the BERT in
    f32; TPU.GDINO_ENC_LAYERS / GDINO_DEC_LAYERS cut the towers, and the
    number of queries comes from the checkpoint."""
    device = resolve_device(device)
    if arch in ("GDINO", "GDINO_CLASSONLY"):
        weight = cfg.MODEL.TEACHER_CLOUD.WEIGHT
        vocab = cfg.get_path("TPU.BERT_VOCAB", "")
        if not (weight and os.path.exists(weight)):
            raise FileNotFoundError(
                f"GDINO checkpoint not found: {weight!r} "
                "(set MODEL.TEACHER_CLOUD.WEIGHT)")
        if not (vocab and os.path.exists(vocab)):
            raise FileNotFoundError(
                "BERT vocab.txt not found (set TPU.BERT_VOCAB)")
        sd = torch.load(weight, map_location="cpu")
        sd = clean_state_dict(sd.get("model", sd))
        variant = cfg.MODEL.TEACHER_CLOUD.TYPE
        enc = cfg.get_path("TPU.GDINO_ENC_LAYERS", 6)
        dec = cfg.get_path("TPU.GDINO_DEC_LAYERS", 6)
        nq = sd["transformer.tgt_embed.weight"].shape[0]
        model = GroundingDINO(variant=variant, num_queries=nq,
                              enc_layers=enc, dec_layers=dec, dtype=dtype)
        model.load_state_dict(convert_gdino(sd, variant, enc, dec),
                              strict=True)
        bert_cfg, bert_sd = bert_state_dict(sd)
        bert = BertModel(bert_cfg)
        bert.load_state_dict(bert_sd, strict=True)
        del sd
        tc = cfg.MODEL.TEACHER_CLOUD
        det = GDINODetector(
            model, bert, class_names, WordPieceTokenizer(vocab),
            threshold=tc.TEST_THRESHOLD,
            per_class_test=tc.get("PER_CLASS_TEST", False),
            type_filter=tc.get("USE_DINO_TYPE_FILTER", False), device=device)
        if arch == "GDINO_CLASSONLY":
            det = ClassOnlyAdapter(det, len(class_names))
        return det
    if arch in ("GLIP", "GLIPModel"):
        raise NotImplementedError(
            "the GLIP cloud teacher (with kernel K8, deform_conv3x3) is not "
            "ported yet (ROADMAP item 20)")
    if arch == "GDINO1_5_API":
        return GDINO15APIDetector(cfg.MODEL.TEACHER_CLOUD.get("TOKEN", ""),
                                  class_names)
    raise ValueError(f"unsupported cloud architecture: {arch}")


def build_clip_scorer(cfg, class_names):
    raise NotImplementedError(
        "the CLIP re-scorer (CLIPScorer with AttentionPool2d, and "
        "engine/clip_setup for its prototypes and weights) is not ported "
        "(ROADMAP items 8b and 21); use --skip-clip, or --synthetic-teacher "
        "for the stub scorer")
