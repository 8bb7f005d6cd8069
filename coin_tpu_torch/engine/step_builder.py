"""The dual-teacher adaptation step (counterpart of
coin_tpu/engine/step_builder.py).

One step, in order: the strong (and weak) view → the EMA teacher update →
the teacher forward on the weak view (live flavor) → A/B/C matching → the
student forward and backward with the complete loss stack → the CKG merge
losses and their gradient (second order through the predictor's ``trans``
MLP) → both optimizer steps → the prototype EMA.

Three flavors, as in the JAX package:
- ``train_step``: the live teacher every step (step_two after burn-up);
- ``train_step_cached``: step_one with the teacher's predictions served
  from a collection pass (the teacher is frozen before burn-up);
- ``train_step_cached_two``: step_two semantics with served predictions.

The merge losses read the student's parameters before this step's update,
so both gradients are taken before either optimizer steps. The merge
optimizer steps every time; its gradient is zero unless the batch sampled
a B row and prototype updates have started. Random draws (the strong
view's values and the RPN and ROI subsampling priorities) come from the
state's generator, or from the caller as a :class:`StepDraws`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from coin_tpu_torch.data.augment import draw_augment, preprocess_batch
from coin_tpu_torch.engine import coin_pipelines, pipelines
from coin_tpu_torch.engine.matching import match_dual_teacher
from coin_tpu_torch.engine.state import (Prototypes, TrainState,
                                         default_freeze_predicate,
                                         ema_update_, freeze, make_teacher,
                                         trainable)
from coin_tpu_torch.models.anchors import cell_anchors
from coin_tpu_torch.models.ckg import CKGNet
from coin_tpu_torch.solver import build_optimizer
from coin_tpu_torch.structures import Detections, truncate


@dataclasses.dataclass(frozen=True)
class StepHyper:
    """Scalar hyper-parameters of the step (the CLOUD.* knobs it reads)."""
    burn_up: int                      # CLOUD.BURN_UP_STEP
    ema_rate: float = 0.9996          # CLOUD.EMA_KEEP_RATE_OFFLINE
    ema_every: int = 1                # CLOUD.OFFLINE_TEACHER_UPDATE_ITER
    proto_rate: float = 0.9996        # CLOUD.PROTOTYPE_UPDATE_WEIGHT
    proto_start: int = 0              # CLOUD.PROTOTYPE_UPDATE_START
    match_thr: float = 0.5            # CLOUD.MATCHER.IOU_THRESHOLDS
    cls_b_thresh: float = 0.7         # CLOUD.CLS_B_THRESH
    cap_c: int = 64                   # TPU.CAP_C
    loss_weights: Optional[Dict[str, float]] = None  # CLOUD.*_WEIGHT


@dataclasses.dataclass
class StepDraws:
    """The random values one step consumes."""
    augment: torch.Tensor     # (B, 9), see data.augment.draw_augment
    rpn: torch.Tensor         # (B, 2, anchors) (pos, neg) priorities
    roi: torch.Tensor         # (B, 2, P + Na + Nb) (pos, neg) priorities


def num_candidates(cfg: pipelines.PipelineConfig, num_online: int,
                   num_offline: int) -> int:
    """ROI sampling candidates per image: the train proposals, then the A
    set (No + Nf) and the B set (No) appended as ground truth."""
    return cfg.post_nms_topk_train + 2 * num_online + num_offline


def draw_step(generator: torch.Generator, batch: int, num_anchors: int,
              candidates: int) -> StepDraws:
    dev = generator.device
    return StepDraws(
        augment=draw_augment(generator, batch),
        rpn=torch.rand((batch, 2, num_anchors), generator=generator,
                       device=dev),
        roi=torch.rand((batch, 2, candidates), generator=generator,
                       device=dev))


def hyper_from_cfg(cfg) -> StepHyper:
    return StepHyper(
        burn_up=cfg.CLOUD.BURN_UP_STEP,
        ema_rate=cfg.CLOUD.EMA_KEEP_RATE_OFFLINE,
        ema_every=cfg.CLOUD.OFFLINE_TEACHER_UPDATE_ITER,
        proto_rate=cfg.CLOUD.PROTOTYPE_UPDATE_WEIGHT,
        proto_start=cfg.CLOUD.PROTOTYPE_UPDATE_START,
        match_thr=cfg.CLOUD.MATCHER.IOU_THRESHOLDS,
        cls_b_thresh=cfg.CLOUD.CLS_B_THRESH,
        cap_c=cfg.get_path("TPU.CAP_C", 64))


def init_train_state(cfg, model, class_tokens: torch.Tensor,
                     seed: int, proto0: Optional[torch.Tensor] = None
                     ) -> TrainState:
    """The state at step 0 for ``model`` (already holding its weights):
    the freeze set of ``MODEL.BACKBONE.FREEZE_AT`` and
    ``CLOUD.UPDATE_BACKBONE``, the EMA teacher, a CKG net with random
    weights from ``seed + 2``, both optimizers (the merge one without
    per-module multipliers) and the prototypes, which start as ``proto0``
    (the trainer's template-mean prototypes under CLIP assets) or else as
    the prompt text features (the JAX package's choice without them). The
    step's generator lives on the model's device, seeded ``seed + 1``."""
    dev = next(model.parameters()).device
    freeze(model, default_freeze_predicate(
        cfg.CLOUD.UPDATE_BACKBONE, cfg.MODEL.BACKBONE.FREEZE_AT))
    merge_model = CKGNet(cfg.MODEL.MERGE_DIM, model.num_classes + 1) \
        .random_init(seed + 2).to(dev)
    if proto0 is None:
        with torch.no_grad():
            proto0 = model.text_features(class_tokens).float()
    return TrainState(
        model=model, teacher=make_teacher(model), merge_model=merge_model,
        optimizer=build_optimizer(trainable(model), cfg),
        merge_optimizer=build_optimizer(merge_model.named_parameters(), cfg,
                                        overrides={}),
        prototypes=Prototypes(proto0.clone(), proto0.clone(),
                              proto0.clone()),
        step=0,
        generator=torch.Generator(device=dev).manual_seed(seed + 1))


def build_adaptation_steps(class_tokens: torch.Tensor,
                           pcfg: pipelines.PipelineConfig,
                           teacher_pcfg: pipelines.PipelineConfig,
                           hyper: StepHyper,
                           on_stage: Optional[Callable[[str], None]] = None):
    """Returns ``(train_step, train_step_cached, train_step_cached_two)``.

    ``train_step(state, images_u8, image_hw, online_rcnn, online_rpn,
    draws=None) -> (state, losses)``; the cached flavors take the offline
    predictions after ``online_rpn``. Detections are batched and padded,
    with probs; images are uint8 (B, H, W, 3) on the model's device (the
    loader flips on the host). ``state`` is updated in place and returned;
    ``losses`` are detached scalars. ``on_stage(name)``, when given, is
    called as each stage ends: "augment", "teacher" (the EMA, and the
    teacher forward of the live flavor), "student_forward" (matching
    included), "backward", "merge", "update" (both optimizers and the
    prototype EMA); a timer hangs there."""
    h = hyper
    mark = on_stage or (lambda stage: None)

    def step_body(state: TrainState, strong, image_hw, online_rcnn,
                  online_rpn, offline: Detections, step_two: bool,
                  draws: StepDraws):
        model, merge_model = state.model, state.merge_model
        protos = state.prototypes
        box_a_w = 0.5 if step_two else 1.0
        matched_rcnn = match_dual_teacher(online_rcnn, offline, h.match_thr,
                                          box_a_w, with_b=True)
        matched_rpn = match_dual_teacher(online_rpn, offline, h.match_thr,
                                         box_a_w, with_b=False)
        matched_rcnn = matched_rcnn._replace(
            c=truncate(matched_rcnn.c, h.cap_c))
        matched_rpn = matched_rpn._replace(c=truncate(matched_rpn.c,
                                                      h.cap_c))
        update_prototype = h.proto_start != -1 and state.step >= \
            h.proto_start

        def merge_probs_fn(feats_b, p_off, p_on):
            return merge_model(feats_b, protos.b_offline, protos.b_online,
                               p_off, p_on)

        # ---- student forward and backward ----
        state.optimizer.zero_grad()
        fw = coin_pipelines.student_forward(
            model, strong, image_hw, matched_rcnn, matched_rpn,
            class_tokens, draws.rpn, draws.roi, pcfg, step_two,
            protos.proto, merge_probs_fn, h.cls_b_thresh)
        losses = coin_pipelines.apply_loss_weights(fw.losses, h.loss_weights)
        mark("student_forward")
        sum(losses.values()).backward()
        mark("backward")

        # ---- CKG merge gradient, from the pre-update student ----
        with torch.no_grad():
            text = model.text_features(class_tokens)
        mlosses = coin_pipelines.merge_losses(
            merge_model, model, fw, protos, pcfg.num_classes, text)
        mparams = list(merge_model.parameters())
        mgrads = torch.autograd.grad(
            mlosses["loss_merge_grad"] + mlosses["loss_merge_base"],
            mparams, allow_unused=True)
        train_merge = (fw.sp.group == 1).any() & update_prototype
        for p, g in zip(mparams, mgrads):
            g = torch.zeros_like(p) if g is None else g
            p.grad = torch.where(train_merge, g, torch.zeros_like(g))
        mark("merge")

        # ---- both updates, then the prototype EMA ----
        state.optimizer.step()
        state.merge_optimizer.step()
        state.prototypes = coin_pipelines.update_prototypes(
            protos, fw, pcfg.num_classes, h.proto_rate, update_prototype)
        state.step += 1
        mark("update")
        out = {k: v.detach() for k, v in losses.items()}
        out.update({k: v.detach() for k, v in mlosses.items()})
        return state, out

    def draws_for(state, images_u8, online, offline_cap):
        b, hh, ww, _ = images_u8.shape
        anchors = (hh // pcfg.stride) * (ww // pcfg.stride) \
            * cell_anchors().shape[0]
        return draw_step(state.generator, b, anchors, num_candidates(
            pcfg, online.capacity, offline_cap))

    def ema(state):
        step_two = state.step >= h.burn_up
        if step_two and (state.step - h.burn_up) % h.ema_every == 0:
            ema_update_(state.teacher, state.model, h.ema_rate)
        return step_two

    def train_step(state: TrainState, images_u8, image_hw, online_rcnn,
                   online_rpn, draws: Optional[StepDraws] = None):
        draws = draws or draws_for(state, images_u8, online_rcnn,
                                   teacher_pcfg.test_topk)
        strong, weak = preprocess_batch(images_u8, draws.augment)
        mark("augment")
        step_two = ema(state)
        with torch.no_grad():
            offline = pipelines.inference(state.teacher, weak, image_hw,
                                          class_tokens, teacher_pcfg)
        mark("teacher")
        return step_body(state, strong, image_hw, online_rcnn, online_rpn,
                         offline, step_two, draws)

    def train_step_cached(state: TrainState, images_u8, image_hw,
                          online_rcnn, online_rpn, offline: Detections,
                          draws: Optional[StepDraws] = None):
        draws = draws or draws_for(state, images_u8, online_rcnn,
                                   offline.capacity)
        strong, _ = preprocess_batch(images_u8, draws.augment, weak=False)
        mark("augment")
        return step_body(state, strong, image_hw, online_rcnn, online_rpn,
                         offline, False, draws)

    def train_step_cached_two(state: TrainState, images_u8, image_hw,
                              online_rcnn, online_rpn, offline: Detections,
                              draws: Optional[StepDraws] = None):
        draws = draws or draws_for(state, images_u8, online_rcnn,
                                   offline.capacity)
        strong, _ = preprocess_batch(images_u8, draws.augment, weak=False)
        mark("augment")
        step_two = ema(state)
        mark("teacher")
        return step_body(state, strong, image_hw, online_rcnn, online_rpn,
                         offline, step_two, draws)

    return train_step, train_step_cached, train_step_cached_two
