"""CLIP text tower with learnable prompt tokens (counterpart of
coin_tpu/models/text_encoder.py:30-144).

As in the JAX package the residual stream stays in the dtype of the token
embeddings (f32); the attention and MLP linears run in the compute dtype;
LayerNorm (flax's ε = 1e-6) runs in f32 and casts back. Every parameter
is held in f32. The text feature
is taken at the EOT position, the argmax token id.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from coin_tpu_torch.models.layers import Linear

LN_EPS = 1e-6  # flax.linen.LayerNorm default


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class SelfAttention(nn.Module):
    """flax ``SelfAttention``: q/k/v/out projections with bias, the query
    scaled by 1/√head_dim, softmax over masked logits."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = Linear(width, width)
        self.key = Linear(width, width)
        self.value = Linear(width, width)
        self.out = Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        n, l, d = x.shape
        hd = d // self.heads
        split = lambda t: t.reshape(n, l, self.heads, hd).transpose(1, 2)
        q = split(self.query(x)) / (hd ** 0.5)
        k, v = split(self.key(x)), split(self.value(x))
        logits = q @ k.transpose(-1, -2)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        attn = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(n, l, d)
        return self.out(out)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = SelfAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp_c_fc = Linear(width, width * 4)
        self.mlp_c_proj = Linear(width * 4, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dtype = self.mlp_c_fc.compute_dtype or x.dtype
        h = self.ln_1(x.float()).to(x.dtype)
        x = x + self.attn(h.to(dtype), mask)
        h = self.ln_2(x.float()).to(x.dtype)
        h = quick_gelu(self.mlp_c_fc(h.to(dtype)))
        return x + self.mlp_c_proj(h)


class TextTransformer(nn.Module):
    """The frozen CLIP text trunk: token embeddings in, L2-normalised
    projected features out (causal mask)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, heads: int = 8, layers: int = 12,
                 embed_dim: int = 1024):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(context_length, width))
        for i in range(layers):
            self.add_module(f"resblock_{i}",
                            ResidualAttentionBlock(width, heads))
        self.layers = layers
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))

    def encode_embeds(self, x: torch.Tensor,
                      eot_index: torch.Tensor) -> torch.Tensor:
        """x (N, L, width) token embeddings; eot_index (N,) → (N, embed)."""
        n, l, _ = x.shape
        x = x + self.positional_embedding[None].to(x.dtype)
        mask = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x, mask)
        x = self.ln_final(x.float()).to(x.dtype)
        pooled = x[torch.arange(n, device=x.device), eot_index]
        feats = pooled @ self.text_projection.to(pooled.dtype)
        return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Integer token sequences (N, L); EOT = argmax token id."""
        return self.encode_embeds(self.token_embedding(tokens),
                                  tokens.argmax(dim=-1))


class PromptedTextEncoder(nn.Module):
    """Learnable-prompt class embeddings: positions 1..tmp_len take the
    template embeddings, the next ``add_prompt_num`` the learnable context
    tokens; the trunk is shared with the detector."""

    def __init__(self, width: int, prompt_tmp_len: int = 4,
                 add_prompt_num: int = 4):
        super().__init__()
        self.prompt_tmp_len = prompt_tmp_len
        self.embedding_tmp = nn.Parameter(torch.zeros(prompt_tmp_len, width))
        self.add_in_embedding = nn.Parameter(
            torch.zeros(add_prompt_num, width))

    def forward(self, trunk: TextTransformer, class_token_embeds: torch.Tensor,
                eot_index: torch.Tensor) -> torch.Tensor:
        x = class_token_embeds.clone()
        t, a = self.prompt_tmp_len, self.add_in_embedding.shape[0]
        x[:, 1:1 + t] = self.embedding_tmp.to(x.dtype)
        x[:, 1 + t:1 + t + a] = self.add_in_embedding.to(x.dtype)
        return trunk.encode_embeds(x, eot_index)
