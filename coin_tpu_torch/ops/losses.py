"""Loss primitives with explicit validity masks (counterpart of
coin_tpu/ops/losses.py:19-107).

Every loss does its own safe reduction: the mean over valid rows, and
exactly 0.0 when no row is valid. In a data-parallel step the count is
the global batch's (``parallel/mesh_utils.global_sum``), so each rank's
loss is its share of the global mean.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from coin_tpu_torch.parallel import mesh_utils


def masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    cnt, = mesh_utils.global_sum(valid.sum())
    total = torch.where(valid, x, torch.zeros_like(x)).sum()
    return torch.where(cnt > 0, total / cnt.clamp_min(1),
                       torch.zeros_like(total))


def mil_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                      valid: torch.Tensor,
                      weights: Optional[torch.Tensor] = None,
                      avg_positives: bool = False) -> torch.Tensor:
    """Multi-instance CE: −log Σ target·softmax(logits) (or the
    positive-average variant)."""
    pos = (target * torch.softmax(logits, dim=-1)).sum(-1)
    if avg_positives:
        pos = pos / (target.sum(-1) + 1e-6)
    loss = -torch.log(pos.clamp_min(1e-20))
    if weights is not None:
        loss = loss * weights
    return masked_mean(loss, valid)


def mil_focal_loss(logits: torch.Tensor, target: torch.Tensor,
                   valid: torch.Tensor, alpha: Optional[torch.Tensor] = None,
                   gamma: float = 1.5,
                   avg_positives: bool = True) -> torch.Tensor:
    """Multi-instance focal loss."""
    if alpha is None:
        alpha = torch.ones(logits.shape[-1], dtype=logits.dtype,
                           device=logits.device)
    probs = torch.softmax(logits, dim=-1)
    a = (target * alpha[None, :]).sum(-1) / (target.sum(-1) + 1e-6)
    p = (target * probs).sum(-1)
    if avg_positives:
        p = p / (target.sum(-1) + 1e-6)
    loss = -a * ((1.0 - p) ** gamma) * torch.log(p.clamp_min(1e-20))
    return masked_mean(loss, valid)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 0.0) -> torch.Tensor:
    """Elementwise smooth-L1 (beta = 0 → L1, detectron2's convention)."""
    diff = (pred - target).abs()
    if beta <= 0.0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def kl_div(log_pred: torch.Tensor, target_probs: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """KL(target || pred) summed over the last dim, averaged over valid
    rows."""
    per_elem = target_probs * (torch.log(target_probs.clamp_min(1e-20))
                               - log_pred)
    return masked_mean(per_elem.sum(-1), valid)


def cosine_rows(a: torch.Tensor, b: torch.Tensor, dim: int = -1,
                eps: float = 1e-8) -> torch.Tensor:
    na = torch.linalg.vector_norm(a, dim=dim)
    nb = torch.linalg.vector_norm(b, dim=dim)
    return (a * b).sum(dim) / (na * nb).clamp_min(eps)


def gradient_discrepancy(grads_a: Sequence[torch.Tensor],
                         grads_b: Sequence[torch.Tensor]) -> torch.Tensor:
    """1 − mean cosine between two lists of gradients: per parameter, a
    matrix takes the mean of its per-output-unit cosines, a vector one
    cosine. ``grads_a`` is detached. Matrices are torch's (out, in): the
    per-output reduction is over dim 1, where the JAX package reduces flax
    kernels (in, out) over axis 0."""
    sims = []
    for ga, gb in zip(grads_a, grads_b):
        ga = ga.detach()
        if ga.dim() > 1:
            sims.append(cosine_rows(ga.reshape(ga.shape[0], -1),
                                    gb.reshape(gb.shape[0], -1),
                                    dim=1).mean())
        else:
            sims.append(cosine_rows(ga, gb))
    return 1.0 - torch.stack(sims).mean()
