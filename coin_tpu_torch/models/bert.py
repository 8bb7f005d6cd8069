"""BERT text encoder of the Grounding DINO cloud teacher.

Counterpart of the ``FlaxBertModel`` that coin_tpu/models/convert_gdino.py
:198-215 builds through ``transformers`` (the machine with the card has no
``transformers``, so the port carries its own): embeddings (word +
token type + position, LayerNorm), post-LN encoder layers with exact-erf
GELU, ``last_hidden_state`` out. Parameter names are HF's torch
``BertModel`` names, so a GDINO checkpoint's ``bert.*`` keys load with the
prefix stripped, and a Flax BERT tree converts through
``convert_from_jax.from_jax_variables``. The pooler's weights are kept so
both load strictly; it is not computed (GDINO reads the hidden states).

As in Flax: the query is divided by sqrt(head dim) before the product
with the keys, and a padded token's attention bias is the dtype's most
negative finite value.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from coin_tpu_torch.models.layers import Linear


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


def infer_bert_config(bert_sd: Dict[str, torch.Tensor]) -> BertConfig:
    """BERT geometry from a state dict's shapes (coin_tpu/models/
    convert_gdino.py:178-195 ``infer_bert_config``)."""
    vocab, hidden = bert_sd["embeddings.word_embeddings.weight"].shape
    layers = len({k.split(".")[2] for k in bert_sd
                  if k.startswith("encoder.layer.")})
    inter = bert_sd["encoder.layer.0.intermediate.dense.weight"].shape[0]
    max_pos = bert_sd["embeddings.position_embeddings.weight"].shape[0]
    return BertConfig(vocab_size=vocab, hidden_size=hidden,
                      num_hidden_layers=layers,
                      num_attention_heads=max(1, hidden // 64),
                      intermediate_size=inter,
                      max_position_embeddings=max_pos)


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[-1], device=ids.device)
        x = (self.word_embeddings(ids)
             + self.token_type_embeddings(torch.zeros_like(ids))
             + self.position_embeddings(pos)[None])
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.query, self.key, self.value = Linear(d, d), Linear(d, d), \
            Linear(d, d)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        hd = d // self.heads
        split = lambda y: y.reshape(b, t, self.heads, hd)
        q = split(self.query(x))
        q = q / torch.tensor(hd, dtype=q.dtype, device=q.device).sqrt()
        w = torch.einsum("bqhd,bkhd->bhqk", q, split(self.key(x))) + bias
        w = torch.softmax(w, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, split(self.value(x)))
        return out.reshape(b, t, d)


class _DenseLN(nn.Module):
    """dense → + residual → LayerNorm (HF's BertSelfOutput / BertOutput)."""

    def __init__(self, cfg: BertConfig, d_in: int):
        super().__init__()
        self.dense = Linear(d_in, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, residual):
        return self.LayerNorm(self.dense(x) + residual)


class _Attention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = _SelfAttention(cfg)
        self.output = _DenseLN(cfg, cfg.hidden_size)


class _Intermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.intermediate_size)


class _Layer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Intermediate(cfg)
        self.output = _DenseLN(cfg, cfg.intermediate_size)

    def forward(self, x, bias):
        a = self.attention.output(self.attention.self(x, bias), x)
        h = F.gelu(self.intermediate.dense(a), approximate="none")
        return self.output(h, a)


class _Encoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(cfg)
                                   for _ in range(cfg.num_hidden_layers))


class _Pooler(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)


class BertModel(nn.Module):
    """``forward(ids (B, T) int, mask (B, T) bool) → (B, T, hidden)``
    last hidden states, in f32."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.pooler = _Pooler(cfg)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(ids.long())
        lowest = torch.finfo(x.dtype).min
        bias = torch.where(mask[:, None, None, :].bool(),
                           torch.zeros((), dtype=x.dtype, device=x.device),
                           torch.full((), lowest, dtype=x.dtype,
                                      device=x.device))
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x
