"""Exact greedy hard NMS (counterpart of coin_tpu/ops/nms.py:42-131,
``nms_keep_mask``), batched over leading image dims; the
Probabilistic-Fusion NMS of the collection pass (``fusion_nms``, :137);
and the pairwise fusion helpers (``merge_probs_*``,
``weighted_box_fusion_pair``, :230-258).

On a CUDA tensor the sorted-box suppression runs in kernel K3
(csrc/nms.cu, launched by kernels/nms.py) and the fusion NMS in kernel K6
(csrc/fusion_nms.cu, kernels/fusion_nms.py); on a CPU tensor they run in
:func:`nms_sorted_plain` and :func:`fusion_nms_plain`, the plain PyTorch
versions. Around K3 everything is PyTorch: the class offset, the +1 shift
of valid rows, the stable descending score sort and the inverse
permutation. :func:`iou_exceeds` is K3's division-free IoU test written in
PyTorch, and :func:`iou_at_least` K11's (csrc/dedup.cu) ``>=`` form of it,
both held by the CPU tests to the quotient's test.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from coin_tpu_torch.ops import boxes as box_ops
from coin_tpu_torch.structures import Detections

NEG_INF = -1e30


def _offset_by_class(boxes: torch.Tensor, classes: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Shift each class into its own coordinate range (coin_tpu/ops/
    nms.py:42-45); ``max_coord`` is taken per image over valid rows."""
    masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = masked.amax(dim=(-2, -1), keepdim=True)[..., 0]
    return boxes + (classes.to(boxes.dtype) * (max_coord + 1.0))[..., None]


def nms_sorted_plain(sboxes: torch.Tensor, counts: torch.Tensor,
                     iou_threshold: float, plus1: bool) -> torch.Tensor:
    """Plain version of K3. sboxes (B, N, 4) sorted by descending score
    with the ``counts[b]`` valid rows first → keep (B, N) bool."""
    iou_fn = box_ops.pairwise_iou_plus1 if plus1 else box_ops.pairwise_iou
    b, n, _ = sboxes.shape
    keep = torch.zeros((b, n), dtype=torch.bool)
    for i, count in enumerate(counts.tolist()):
        boxes = sboxes[i, :count]
        over = (iou_fn(boxes, boxes) > iou_threshold).triu(1).cpu()
        removed = torch.zeros(count, dtype=torch.bool)
        for r in range(count):
            if not removed[r]:
                removed |= over[r]
        keep[i, :count] = ~removed
    return keep.to(sboxes.device)


@functools.lru_cache(maxsize=None)
def threshold_split(iou_threshold: float) -> Tuple[float, float, float,
                                                   bool]:
    """(thr, h, umin, fast) of K3's division-free IoU test: the f32
    threshold; h, half the gap to the next float, so that thr + h is the
    rounding boundary above thr; the least union for which h * union is a
    normal float; and whether the test applies (0 < thr <= 1, h normal);
    else every pair takes the division."""
    thr = float(np.float32(iou_threshold))
    h = (float(np.nextafter(np.float32(thr), np.float32(np.inf))) - thr) / 2
    fast = 2.0 ** -102 <= thr <= 1.0
    umin = max(2.0 ** -100, 2.0 ** -126 / h) if fast else 0.0
    return thr, h, umin, fast


@functools.lru_cache(maxsize=None)
def threshold_split_at_least(iou_threshold: float) -> Tuple[float, float,
                                                            float, bool]:
    """:func:`threshold_split` for the test ``inter / union >= thr`` (K11):
    the split of thr-, the f32 just below f32(thr), since a rounded
    quotient is >= thr exactly when it is > thr-."""
    below = np.nextafter(np.float32(iou_threshold), np.float32(-np.inf))
    return threshold_split(float(below))


def iou_decides(inter: torch.Tensor, union: torch.Tensor,
                iou_threshold: float):
    """K3's IoU test without the division (csrc/nms.cu, the mask kernel)
    on f32 ``inter`` and ``union``: (where it decides, its verdict of
    ``inter / union > thr`` there). It compares r = inter - thr * union,
    rounded once to f32 as the kernel's FMA rounds it, with h * union,
    exact in f32 for a union in [umin, 2**100]: r above it means that the
    quotient rounds above thr, r below it that it rounds to thr or below;
    r never equals it there (their difference is a nonzero multiple of h
    * union's ulp). It decides nothing for unions outside that range, nor
    for thresholds outside (0, 1]: the kernel divides for those."""
    thr, h, umin, fast = threshold_split(iou_threshold)
    # thr * union is exact in f64; the f64 difference rounds on to f32 at
    # most where it is far from h * union, which no rounding crosses
    r = (inter.double() - thr * union.double()).float()
    hu = union.float() * h
    decided = (union >= umin) & (union <= 2.0 ** 100)
    if not fast:
        decided = torch.zeros_like(decided)
    return decided, r > hu


def iou_exceeds(inter: torch.Tensor, union: torch.Tensor,
                iou_threshold: float) -> torch.Tensor:
    """The suppression test of K3 in PyTorch, used by no path:
    ``inter / union > thr`` where union > 0, else ``0 > thr``, the quotient
    used only where :func:`iou_decides` does not decide."""
    thr = float(np.float32(iou_threshold))
    inter, union = inter.float(), union.float()
    positive = union > 0
    decided, verdict = iou_decides(inter, union, iou_threshold)
    quotient = torch.where(positive, inter / union,
                           torch.zeros_like(inter)) > thr
    return torch.where(positive & decided, verdict, quotient)


def iou_at_least(inter: torch.Tensor, union: torch.Tensor,
                 iou_threshold: float) -> torch.Tensor:
    """K11's join test in PyTorch, used by no path: ``inter / union >= thr``
    where union > 0, else ``0 >= thr``, decided as :func:`iou_exceeds`
    decides ``> thr-`` (:func:`threshold_split_at_least`)."""
    below = threshold_split_at_least(iou_threshold)[0]
    return iou_exceeds(inter, union, below)


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  valid: torch.Tensor, iou_threshold: float,
                  classes: Optional[torch.Tensor] = None,
                  plus1: bool = False) -> torch.Tensor:
    """Greedy NMS keep mask aligned with the input rows.

    boxes (..., N, 4), scores/valid/classes (..., N); class-aware when
    ``classes`` is given (detectron2 batched_nms). Ties in score break by
    input order (stable sort), as in the JAX package.
    """
    lead = boxes.shape[:-2]
    n = boxes.shape[-2]
    boxes = boxes.reshape(-1, n, 4).float()
    scores = scores.reshape(-1, n)
    valid = valid.reshape(-1, n)
    if classes is not None:
        boxes = _offset_by_class(boxes, classes.reshape(-1, n).clamp_min(0),
                                 valid)
    # shift real boxes to strictly positive coordinates and zero the rest,
    # so a zero row never overlaps a real box
    boxes = torch.where(valid[..., None], boxes + 1.0,
                        torch.zeros_like(boxes))
    masked = torch.where(valid, scores.float(),
                         torch.full_like(scores, NEG_INF, dtype=torch.float32))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    # valid rows first even where a valid score is <= NEG_INF: the kernel
    # takes the valid rows as a prefix of length counts[b]
    first = torch.sort((~valid).gather(1, order).to(torch.uint8), dim=-1,
                       stable=True).indices
    order = order.gather(1, first)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    counts = valid.sum(-1, dtype=torch.int32)
    if boxes.is_cuda:
        from coin_tpu_torch.kernels.nms import nms_sorted_cuda
        keep_sorted = nms_sorted_cuda(sboxes, counts, iou_threshold, plus1)
    else:
        keep_sorted = nms_sorted_plain(sboxes, counts, iou_threshold, plus1)
    keep = torch.empty_like(keep_sorted)
    keep.scatter_(1, order, keep_sorted)
    return (keep & valid).reshape(lead + (n,))


SCORE_METHODS = ("probEn", "avg", "max")
BOX_METHODS = ("s-avg", "avg", "max")


def fusion_nms_plain(boxes: torch.Tensor, probs: torch.Tensor,
                     classes: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float, score_method: str,
                     box_method: str):
    """Plain version of K6, batched over images, in nms.py:137-224's
    order. boxes (B, N, 4), probs (B, N, C+1), classes (B, N), valid
    (B, N) → fused (boxes, scores, probs, classes int32, valid) in
    emission order (the cluster seeds by descending score), before the
    re-sort."""
    b, n, c1 = probs.shape
    dev = boxes.device
    ar = torch.arange(b, device=dev)
    cls0 = classes.clamp_min(0).long()
    off = _offset_by_class(boxes, cls0, valid)
    off = torch.where(valid[..., None], off, torch.zeros_like(off))
    scores = torch.gather(probs, -1, cls0[..., None])[..., 0]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    logp = torch.log(probs.clamp_min(1e-20))
    out_boxes = torch.zeros_like(boxes)
    out_scores = torch.zeros_like(scores)
    out_probs = torch.zeros_like(probs)
    out_classes = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    out_valid = torch.zeros((b, n), dtype=torch.bool, device=dev)
    alive = valid.clone()
    one = torch.ones((), device=dev)
    for k in range(n):
        cur = torch.where(alive, scores, torch.full_like(scores, NEG_INF))
        top = cur.argmax(dim=-1)
        write = cur[ar, top] > NEG_INF / 2
        if not bool(write.any()):
            break           # no image has a row left: the rest stays empty
        iou = box_ops.pairwise_iou_plus1(off[ar, top][:, None], off)[:, 0]
        cluster = alive & (iou > iou_threshold)
        cluster[ar, top] = alive[ar, top]
        csz = torch.maximum(cluster.sum(-1).to(boxes.dtype), one)[:, None]
        w = torch.where(cluster, scores, torch.zeros_like(scores))
        if score_method == "probEn":
            summed = torch.where(cluster[..., None], logp,
                                 torch.zeros_like(logp)).sum(1)
            fprob = torch.softmax(summed, dim=-1)
            fcls = classes[ar, top]
            fscore = fprob[ar, fcls.clamp_min(0).long()]
        elif score_method == "avg":
            fprob = torch.where(cluster[..., None], probs,
                                torch.zeros_like(probs)).sum(1) / csz
            fscore = w.sum(-1) / csz[:, 0]
            fcls = classes[ar, top]
        elif score_method == "max":
            mi = torch.where(cluster, scores,
                             torch.full_like(scores, NEG_INF)).argmax(-1)
            fprob, fscore, fcls = probs[ar, mi], scores[ar, mi], \
                classes[ar, mi]
        else:
            raise NotImplementedError(score_method)
        if box_method == "s-avg":
            bw = w / torch.maximum(w.sum(-1, keepdim=True),
                                   torch.full_like(w[:, :1], 1e-20))
            fbox = (boxes * bw[..., None]).sum(1)
        elif box_method == "avg":
            fbox = torch.where(cluster[..., None], boxes,
                               torch.zeros_like(boxes)).sum(1) / csz
        elif box_method == "max":
            mi = torch.where(cluster, scores,
                             torch.full_like(scores, NEG_INF)).argmax(-1)
            fbox = boxes[ar, mi]
        else:
            raise NotImplementedError(box_method)
        wr = write[:, None]
        out_boxes[:, k] = torch.where(wr, fbox, torch.zeros_like(fbox))
        out_scores[:, k] = torch.where(write, fscore,
                                       torch.zeros_like(fscore))
        out_probs[:, k] = torch.where(wr, fprob, torch.zeros_like(fprob))
        out_classes[:, k] = torch.where(write, fcls.int(),
                                        torch.full_like(out_classes[:, k], -1))
        out_valid[:, k] = write
        alive = alive & ~cluster
    return out_boxes, out_scores, out_probs, out_classes, out_valid


def fusion_nms(det: Detections, iou_threshold: float,
               score_method: str = "probEn",
               box_method: str = "s-avg") -> Detections:
    """Greedy NMS that fuses each suppression cluster instead of dropping
    it (coin_tpu/ops/nms.py:137 ``fusion_nms``, the reference's
    ``nms_bayesian``), batched over the leading image dim (B, N). IoU uses
    the inclusive +1 convention; clusters are same-class (coordinate
    offset); the fused set is re-sorted by fused score, stably.

    score_method: 'probEn' | 'avg' | 'max'; box_method: 's-avg' | 'avg' |
    'max'. On a CUDA tensor the loop and the re-sort run in kernel K6
    (csrc/fusion_nms.cu); on a CPU tensor in :func:`fusion_nms_plain`."""
    if det.probs is None:
        raise ValueError("fusion_nms needs per-class probs")
    if score_method not in SCORE_METHODS or box_method not in BOX_METHODS:
        raise NotImplementedError(f"{score_method}, {box_method}")
    boxes, probs = det.boxes.float(), det.probs.float()
    if boxes.is_cuda:
        from coin_tpu_torch.kernels.fusion_nms import fusion_nms_cuda
        b, s, p, c, v = fusion_nms_cuda(boxes, probs, det.classes.int(),
                                        det.valid, iou_threshold,
                                        SCORE_METHODS.index(score_method),
                                        BOX_METHODS.index(box_method))
        return Detections(boxes=b, scores=s, classes=c, valid=v, probs=p)
    b, s, p, c, v = fusion_nms_plain(boxes, probs, det.classes, det.valid,
                                     iou_threshold, score_method, box_method)
    out = Detections(boxes=b, scores=s, classes=c, valid=v, probs=p)
    # emitted in descending seed order, but the reference re-sorts by the
    # fused score (the reference's nms.py:192)
    key = -torch.where(v, s, torch.full_like(s, NEG_INF))
    order = torch.sort(key, dim=-1, stable=True).indices
    return out.gather(order, torch.gather(v, -1, order))


def merge_probs_bayesian(probs_a: torch.Tensor, probs_b: torch.Tensor):
    """Log-mean fusion of two aligned prob sets (coin_tpu/ops/nms.py:230)
    → (probs, max prob)."""
    summed = (torch.log(probs_a.clamp_min(1e-20))
              + torch.log(probs_b.clamp_min(1e-20))) / 2.0
    probs = torch.softmax(summed, dim=-1)
    return probs, probs.amax(dim=-1)


def merge_probs_max(probs_a: torch.Tensor, probs_b: torch.Tensor):
    """The row with the larger max prob wins whole (coin_tpu/ops/nms.py
    :240) → (probs, max prob)."""
    sa, sb = probs_a.amax(dim=-1), probs_b.amax(dim=-1)
    probs = torch.where((sa > sb)[..., None], probs_a, probs_b)
    return probs, torch.where(sa > sb, sa, sb)


def weighted_box_fusion_pair(box_a: torch.Tensor, box_b: torch.Tensor,
                             score_a: torch.Tensor,
                             score_b: torch.Tensor) -> torch.Tensor:
    """Score-weighted average of two aligned box sets
    (coin_tpu/ops/nms.py:250)."""
    total = (score_a + score_b).clamp_min(1e-20)
    wa = (score_a / total)[..., None]
    wb = (score_b / total)[..., None]
    return box_a * wa + box_b * wb
