"""The pre-train losses, the final-adaptation losses of the student, the
CKG merge losses and the prototype updates (counterpart of
coin_tpu/engine/coin_pipelines.py:27-348).

Random draws come in as tensors: the RPN and ROI subsampling priorities
(``engine/step_builder.draw_step``).

In a data-parallel step (``parallel/mesh_utils.data_parallel``) each rank
computes its share of the global batch's losses: the counts, gates and
prototype sums are global, and the terms that do not depend on the batch
(the text alignment, the CKG's gradient discrepancy) count 1 / W on each
rank, so that the ranks' gradients and losses sum to the global step's.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from coin_tpu_torch.engine import pipelines
from coin_tpu_torch.engine.matching import MatchedSets
from coin_tpu_torch.engine.state import Prototypes, prototype_ema
from coin_tpu_torch.models import roi_heads as rh
from coin_tpu_torch.models import rpn as rpn_lib
from coin_tpu_torch.ops import losses as L
from coin_tpu_torch.parallel import mesh_utils
from coin_tpu_torch.structures import Detections


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp_min(1e-8)


def text_align_loss(text_features: torch.Tensor,
                    proto: torch.Tensor) -> torch.Tensor:
    """L1 between the prompt text features and the (detached, normalised)
    class prototypes; 1 / W of it on each of W data-parallel ranks."""
    loss = (text_features - _normalize(proto).detach()).abs().mean()
    world = mesh_utils.active_world()
    return loss if world == 1 else loss / world


def _flat(a: torch.Tensor) -> torch.Tensor:
    return a.reshape((-1,) + tuple(a.shape[2:]))


class StudentForward(NamedTuple):
    losses: Dict[str, torch.Tensor]
    sp: rh.SampledProposals          # flattened over the batch
    scores: torch.Tensor             # (R, C+1)
    class_feats: torch.Tensor        # (R, text_dim)
    pooled: torch.Tensor             # (R, D) region features
    c_scores: torch.Tensor           # (Rc, C+1) private-box scores
    c_probs: torch.Tensor            # (Rc, C+1) distillation targets
    c_valid: torch.Tensor            # (Rc,)


def pretrain_losses(model, images: torch.Tensor, images_hw: torch.Tensor,
                    rcnn: Detections, rpn_gt: Detections,
                    proto: torch.Tensor, class_tokens: torch.Tensor,
                    rpn_priorities: torch.Tensor,
                    roi_priorities: torch.Tensor,
                    cfg: pipelines.PipelineConfig, update_prototype: bool,
                    prototype_rate: float = 0.9996,
                    prob_weighted: bool = False,
                    loss_weights: Optional[Dict[str, float]] = None
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The pre-train branch: the cached cloud RCNN detections supervise the
    heads (MIL CE, gated on any sampled foreground, and box regression on
    the offline classes), the cached RPN view the RPN; the text-align loss;
    and the prototype EMA over the foreground and background rows when
    ``update_prototype``. ``rpn_priorities`` (B, 2, anchors) and
    ``roi_priorities`` (B, 2, P + Na) are the subsampling draws. Returns
    (weighted losses, new prototypes)."""
    feats = model.features(images)
    anchors = pipelines.anchors_for(images, cfg)
    obj, rpn_deltas, proposals = pipelines.rpn_forward(
        model, feats, images_hw, anchors, cfg, train=True)
    targets = rpn_lib.label_anchors(
        anchors, rpn_gt, None, rpn_priorities, cfg.rpn_batch_size,
        cfg.rpn_positive_fraction, cfg.rpn_thresholds)
    losses = rpn_lib.rpn_losses(anchors, obj, rpn_deltas, targets,
                                cfg.rpn_batch_size)
    sp = rh.sample_proposals(
        proposals, rcnn, None, None, cfg.num_classes, roi_priorities,
        cfg.roi_batch_size, cfg.roi_positive_fraction, cfg.roi_iou_threshold)

    pooled = model.pool_boxes(feats, sp.boxes, cfg.pooler_resolution)
    text = model.text_features(class_tokens)
    scores, deltas, class_feats = model.predict(pooled, text)

    sp_f = rh.SampledProposals(*[_flat(x) for x in sp])
    scores_f = _flat(scores)
    losses["loss_text_align"] = text_align_loss(text, proto)
    cw = (torch.tensor(cfg.classes_weight, device=scores_f.device)
          if cfg.classes_weight else None)
    any_fg = mesh_utils.global_any(sp_f.group == rh.GROUP_A)
    losses["loss_cls"] = torch.where(any_fg, rh.classification_loss(
        scores_f, sp_f, cfg.num_classes, cfg.bg_weight, cfg.loss_type,
        classes_weight=cw, prob_weighted=prob_weighted),
        scores_f.new_zeros(()))
    losses["loss_box_reg"] = rh.box_reg_loss(
        sp_f, _flat(deltas), cfg.num_classes, use_online_classes=False)

    new_proto = proto
    if update_prototype:
        with torch.no_grad():
            rows = (sp_f.group == rh.GROUP_A) | (sp_f.group == rh.GROUP_BG)
            new_proto = prototype_ema(
                proto, _normalize(_flat(class_feats).detach()),
                rh.one_hot_c1(sp_f.cls_offline, cfg.num_classes), rows,
                prototype_rate)
    return apply_loss_weights(losses, loss_weights), new_proto


def student_forward(model, images: torch.Tensor, images_hw: torch.Tensor,
                    matched_rcnn: MatchedSets, matched_rpn: MatchedSets,
                    class_tokens: torch.Tensor, rpn_priorities: torch.Tensor,
                    roi_priorities: torch.Tensor,
                    cfg: pipelines.PipelineConfig, step_two: bool,
                    proto: torch.Tensor, merge_probs_fn: Callable,
                    cls_b_thresh: float = 0.7) -> StudentForward:
    """The student's one forward with every non-merge loss.
    ``merge_probs_fn(feats_b, probs_off, probs_on)`` gives the detached CKG
    fusion that ``loss_cls_b`` distils (step_two only)."""
    b = images.shape[0]
    feats = model.features(images)
    anchors = pipelines.anchors_for(images, cfg)
    obj, rpn_deltas, proposals = pipelines.rpn_forward(
        model, feats, images_hw, anchors, cfg, train=True)
    targets = rpn_lib.label_anchors(
        anchors, matched_rpn.a, matched_rpn.c, rpn_priorities,
        cfg.rpn_batch_size, cfg.rpn_positive_fraction, cfg.rpn_thresholds)
    losses = rpn_lib.rpn_losses(anchors, obj, rpn_deltas, targets,
                                cfg.rpn_batch_size, calc_bg=cfg.bg_train,
                                with_distillation=True)
    sp = rh.sample_proposals(
        proposals, matched_rcnn.a, matched_rcnn.b, matched_rcnn.c,
        cfg.num_classes, roi_priorities, cfg.roi_batch_size,
        cfg.roi_positive_fraction, cfg.roi_iou_threshold,
        b_cls_online=matched_rcnn.b_cls_online,
        b_probs_online=matched_rcnn.b_probs_online, bg_train=cfg.bg_train)

    # sampled and private (C) boxes share one RoIAlign → res5 → predictor
    n_sp = sp.boxes.shape[1]
    all_boxes = torch.cat([sp.boxes, matched_rcnn.c.boxes], 1)
    all_pooled = model.pool_boxes(feats, all_boxes, cfg.pooler_resolution)
    text = model.text_features(class_tokens)
    all_scores, all_deltas, all_feats = model.predict(all_pooled, text)

    sp_f = rh.SampledProposals(*[_flat(x) for x in sp])
    scores_f = _flat(all_scores[:, :n_sp])
    class_feats_f = _flat(all_feats[:, :n_sp])
    pooled_f = _flat(all_pooled[:, :n_sp])
    deltas_f = _flat(all_deltas[:, :n_sp])
    c_scores_f = _flat(all_scores[:, n_sp:])
    c_probs_f = _flat(matched_rcnn.c.probs)
    c_valid_f = _flat(matched_rcnn.c.valid)
    zero = scores_f.new_zeros(())

    losses["loss_text_align"] = text_align_loss(text, proto)
    cw = (torch.tensor(cfg.classes_weight, device=scores_f.device)
          if cfg.classes_weight else None)
    losses["loss_cls"] = rh.classification_loss(
        scores_f, sp_f, cfg.num_classes, cfg.bg_weight, cfg.loss_type,
        classes_weight=cw)

    # probability distillation on the C boxes
    losses["loss_distillation"] = torch.where(
        mesh_utils.global_any(c_valid_f), rh.kl_mean_elements(
            torch.log(torch.softmax(c_scores_f, dim=-1) + 1e-7), c_probs_f,
            c_valid_f), zero)

    # loss_cls_b (step_two only): KL(log p_b || CKG fusion)
    losses["loss_cls_b"] = zero
    if step_two:
        with torch.no_grad():
            merge_b = merge_probs_fn(class_feats_f.detach(),
                                     sp_f.probs_offline, sp_f.probs_online)
        conf = (merge_b.amax(-1) >= cls_b_thresh) \
            & (sp_f.group == rh.GROUP_B)
        kl_b = rh.kl_mean_elements(
            torch.log(torch.softmax(scores_f, dim=-1) + 1e-7), merge_b, conf)
        losses["loss_cls_b"] = torch.where(mesh_utils.global_any(conf),
                                           kl_b, zero)

    # box regression, normalised by the sampled rows while any background
    # row was sampled: class-agnostic, one loss with the online classes;
    # per class, the online and the offline loss, which differ only on the
    # B rows, where the two classes pick different columns
    n_bg, n_rows = mesh_utils.global_sum((sp_f.group == rh.GROUP_BG).sum(),
                                         (sp_f.group != rh.GROUP_PAD).sum())
    total_rows = n_rows.clamp_min(1).float()
    denom = torch.where(n_bg > 0, total_rows, total_rows.new_tensor(
        float(cfg.roi_batch_size * mesh_utils.global_batch(b))))
    if cfg.cls_agnostic_bbox_reg:
        losses["loss_box_reg"] = rh.box_reg_loss(
            sp_f, deltas_f, cfg.num_classes, use_online_classes=True,
            normalizer=denom)
    else:
        for name, online in (("loss_box_reg_online", True),
                             ("loss_box_reg_offline", False)):
            losses[name] = rh.box_reg_loss(
                sp_f, deltas_f, cfg.num_classes, use_online_classes=online,
                normalizer=denom)
    return StudentForward(losses, sp_f, scores_f, class_feats_f, pooled_f,
                          c_scores_f, c_probs_f, c_valid_f)


def merge_losses(merge_model, model, fw: StudentForward,
                 prototypes: Prototypes, num_classes: int,
                 text_features: torch.Tensor,
                 grad_loss_scale: float = 1e4) -> Dict[str, torch.Tensor]:
    """The CKG training losses, differentiable in ``merge_model``'s
    parameters: loss_merge_base (KL of the fused A probabilities against
    one-hot), loss_merge_grad (1 − the cosine between the gradients that
    the A and B MSEs induce on the predictor's ``trans`` MLP; second order
    through ``trans``), and the metric-only loss_merge_a / loss_merge_b.
    ``model`` holds the student's parameters before this step's update.
    In a data-parallel step both gradients are summed over the ranks
    before their cosine, the B one differentiably."""
    a_rows = fw.sp.group == rh.GROUP_A
    b_rows = fw.sp.group == rh.GROUP_B
    one_hot_a = rh.one_hot_c1(fw.sp.cls_offline, num_classes)
    merge_b = merge_model(fw.class_feats.detach(),
                          prototypes.b_offline.detach(),
                          prototypes.b_online.detach(),
                          fw.sp.probs_offline, fw.sp.probs_online)
    losses = {"loss_merge_base": rh.kl_mean_elements(
        torch.log(merge_b + 1e-7), one_hot_a, a_rows)}

    # the class scores as a function of the trans parameters alone
    bp = model.box_predictor
    fixed = {n: p.detach() for n, p in bp.named_parameters()}
    trans = {n: p.detach().clone().requires_grad_(True)
             for n, p in bp.named_parameters() if n.startswith("trans")}
    pooled = fw.pooled.detach().float()
    text = text_features.detach()

    def probs_with(tp):
        class_feats, _ = torch.func.functional_call(bp, {**fixed, **tp},
                                                    (pooled,))
        return torch.softmax(bp.classify(class_feats, text), dim=-1)

    loss_a = grad_loss_scale * rh.masked_mse(probs_with(trans), one_hot_a,
                                             a_rows)
    loss_b = grad_loss_scale * rh.masked_mse(probs_with(trans), merge_b,
                                             b_rows)
    keys = list(trans)
    grads_a = torch.autograd.grad(loss_a, [trans[k] for k in keys])
    grads_b = torch.autograd.grad(loss_b, [trans[k] for k in keys],
                                  create_graph=True)
    world = mesh_utils.active_world()
    if world > 1:
        grads_a = mesh_utils.global_sum(*grads_a)
        grads_b = [mesh_utils.differentiable_sum(g) for g in grads_b]
    # the same on every rank: 1 / W of it each, whose gradients the
    # differentiable sum's backward adds up over the ranks
    losses["loss_merge_grad"] = L.gradient_discrepancy(grads_a, grads_b) \
        / world

    p_all = torch.softmax(fw.scores.detach(), dim=-1)
    losses["loss_merge_a"] = rh.masked_mse(p_all, one_hot_a, a_rows)
    losses["loss_merge_b"] = rh.masked_mse(p_all, merge_b.detach(), b_rows)
    return losses


@torch.no_grad()
def update_prototypes(prototypes: Prototypes, fw: StudentForward,
                      num_classes: int, rate: float,
                      enabled: bool) -> Prototypes:
    """The three prototype EMAs: ``proto`` over A and background rows by
    offline class; ``b_online`` / ``b_offline`` over A, B and background
    rows, only when the batch (the global batch in a data-parallel step)
    sampled a B row."""
    if not enabled:
        return prototypes
    feats = _normalize(fw.class_feats.detach())
    g = fw.sp.group
    a_rows, b_rows, bg_rows = (g == rh.GROUP_A), (g == rh.GROUP_B), \
        (g == rh.GROUP_BG)
    oh_off = rh.one_hot_c1(fw.sp.cls_offline, num_classes)
    oh_on = rh.one_hot_c1(fw.sp.cls_online, num_classes)
    proto = prototype_ema(prototypes.proto, feats, oh_off, a_rows | bg_rows,
                          rate)
    every = a_rows | b_rows | bg_rows
    any_b = mesh_utils.global_any(b_rows)
    b_online = torch.where(any_b, prototype_ema(prototypes.b_online, feats,
                                                oh_on, every, rate),
                           prototypes.b_online)
    b_offline = torch.where(any_b, prototype_ema(prototypes.b_offline, feats,
                                                 oh_off, every, rate),
                            prototypes.b_offline)
    return Prototypes(proto, b_online, b_offline)


def apply_loss_weights(losses: Dict[str, torch.Tensor],
                       weights: Optional[Dict[str, float]]
                       ) -> Dict[str, torch.Tensor]:
    if not weights:
        return losses
    return {k: v * weights.get(k, 1.0) for k, v in losses.items()}
