"""Masked IoU matcher and balanced subsampler (counterpart of
coin_tpu/ops/matcher.py:22-102), batched over leading dims.

``subsample_labels`` takes its random priorities as tensors: the JAX
package draws them inside the function from a key, which cannot be matched
bit for bit, so the caller draws them (``engine/step_builder.draw_step``)
or a test hands in JAX's values.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

NEG_INF = -1e30


def match(quality: torch.Tensor, gt_valid: torch.Tensor,
          thresholds: Sequence[float], labels: Sequence[int],
          allow_low_quality: bool = False
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """detectron2 Matcher semantics.

    quality (..., M, N), rows = gt, cols = predictions; gt_valid (..., M).
    Returns matched_idx (..., N) int64 (0 where no gt is valid) and
    match_labels (..., N) int8 in {-1, 0, 1}.
    """
    assert len(labels) == len(thresholds) + 1
    neg = torch.full_like(quality, NEG_INF)
    q = torch.where(gt_valid[..., :, None], quality, neg)
    any_gt = gt_valid.any(dim=-1, keepdim=True)
    matched_vals, matched_idx = q.max(dim=-2)
    matched_vals = torch.where(any_gt, matched_vals,
                               torch.zeros_like(matched_vals))
    match_labels = torch.full(matched_vals.shape, labels[0], dtype=torch.int8,
                              device=quality.device)
    for lo, lab in zip(thresholds, labels[1:]):
        match_labels = torch.where(matched_vals >= lo,
                                   torch.full_like(match_labels, lab),
                                   match_labels)
    if allow_low_quality:
        best_per_gt = q.amax(dim=-1, keepdim=True)
        is_best = (quality >= best_per_gt) & gt_valid[..., :, None] \
            & (best_per_gt > 0)
        match_labels = torch.where(is_best.any(dim=-2),
                                   torch.ones_like(match_labels),
                                   match_labels)
    match_labels = torch.where(any_gt, match_labels,
                               torch.zeros_like(match_labels))
    return matched_idx, match_labels


def subsample_labels(labels: torch.Tensor, num_samples: int,
                     positive_fraction: float, pri_pos: torch.Tensor,
                     pri_neg: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick up to ``num_samples`` rows of ``labels`` (..., N) with at most
    ``positive_fraction`` positives, the rest negatives; among eligible
    rows the highest priorities (uniform [0, 1), (..., N) each) win, ties
    in index order. Returns the (pos, neg) masks of the sampled rows."""
    n = labels.shape[-1]
    pos = labels == 1
    neg = labels == 0
    num_pos = pos.sum(-1).clamp_max(int(num_samples * positive_fraction))
    num_neg = torch.minimum(neg.sum(-1), num_samples - num_pos)
    kmax = min(num_samples, n)

    def pick(mask, k, pri):
        p = torch.where(mask, pri, torch.full_like(pri, -1.0))
        idx = torch.sort(p, dim=-1, descending=True,
                         stable=True).indices[..., :kmax]
        keep = torch.arange(kmax, device=labels.device) < k[..., None]
        sel = torch.zeros_like(mask).scatter(-1, idx, keep)
        return mask & sel

    return pick(pos, num_pos, pri_pos), pick(neg, num_neg, pri_neg)

