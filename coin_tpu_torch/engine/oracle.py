"""The oracle, supervised training on the ground truth (counterpart of
coin_tpu/engine/oracle.py): the upper bound of the paper's tables, run by
``configs/coin/ORACLE/*.yaml`` (``CLOUD.Trainer: OracleTrainer``). It
trains the detector on the labelled target set with none of the
dual-teacher machinery: no cloud store, no teacher, no CKG net, no
prototypes.

One step, in order: the strong view of the batch (K4, the strong view
alone) → the oracle's losses (``pipelines.oracle_train_losses``) summed
without weights, as JAX's ``sum(losses.values())`` → their backward → one
``ScheduledSGD`` step. Random draws (the strong view's values and the RPN
and ROI subsampling priorities) come from the state's generator, or from
the caller as a ``step_builder.StepDraws`` of one view.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from coin_tpu_torch.data.augment import preprocess_batch
from coin_tpu_torch.data.loader import Batch
from coin_tpu_torch.engine import pipelines
from coin_tpu_torch.engine.base import DetectorTrainerBase
from coin_tpu_torch.engine.common import lr_value
from coin_tpu_torch.engine.state import (TrainState,
                                         default_freeze_predicate, freeze,
                                         trainable)
from coin_tpu_torch.engine.step_builder import (StepDraws, draw_step,
                                                 finish_losses, in_step_group,
                                                 num_anchors, shard_draws)
from coin_tpu_torch.parallel import mesh_utils
from coin_tpu_torch.solver import build_optimizer
from coin_tpu_torch.structures import Detections


def init_oracle_state(cfg, model, seed: int) -> TrainState:
    """The oracle's state at step 0 for ``model`` (already holding its
    weights): the freeze set of ``MODEL.BACKBONE.FREEZE_AT`` and
    ``CLOUD.UPDATE_BACKBONE`` and the optimizer; no teacher, CKG net or
    prototypes, as the JAX ``OracleTrainer``'s ``TrainState``. The step's
    generator lives on the model's device, seeded ``seed + 1``."""
    dev = next(model.parameters()).device
    freeze(model, default_freeze_predicate(
        cfg.CLOUD.UPDATE_BACKBONE, cfg.MODEL.BACKBONE.FREEZE_AT))
    return TrainState(
        model=model, teacher=None, merge_model=None,
        optimizer=build_optimizer(trainable(model), cfg),
        merge_optimizer=None, prototypes=None, step=0,
        generator=torch.Generator(device=dev).manual_seed(seed + 1))


def gt_detections(batch: Batch, device) -> Detections:
    """A batch's ground truth (canvas coordinates) as Detections on
    ``device``, each box scoring 1."""
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    classes = t(batch.gt_classes)
    return Detections(boxes=t(batch.gt_boxes),
                      scores=torch.ones(classes.shape, device=device),
                      classes=classes, valid=t(batch.gt_valid))


def build_oracle_step(class_tokens: torch.Tensor,
                      pcfg: pipelines.PipelineConfig,
                      on_stage: Optional[Callable[[str], None]] = None,
                      group=None):
    """``train_step(state, images_u8, image_hw, gt, draws=None) -> (state,
    losses)``: uint8 images (B, H, W, 3) and the ground truth (B, G) on the
    model's device; ``state`` is updated in place and returned; ``losses``
    are the detached scalars. ``on_stage(name)``, when given, is called as
    each stage ends: "augment", "forward", "backward", "update". With a
    ``group`` of more than one rank each rank passes its shard of the
    global batch (``draws``, when given, are the global batch's): the step
    is data-parallel, as the adaptation step (``step_builder``)."""
    mark = on_stage or (lambda stage: None)

    def train_step(state: TrainState, images_u8, image_hw, gt: Detections,
                   draws: Optional[StepDraws] = None):
        b, hh, ww, _ = images_u8.shape
        if draws is None:
            draws = draw_step(state.generator, mesh_utils.global_batch(b),
                              num_anchors(pcfg, hh, ww),
                              pcfg.post_nms_topk_train + gt.capacity)
        draws = shard_draws(draws, group)
        strong, _ = preprocess_batch(images_u8, draws.augment, weak=False)
        mark("augment")
        state.optimizer.zero_grad()
        losses = pipelines.oracle_train_losses(
            state.model, strong, image_hw, gt, class_tokens, draws.rpn,
            draws.roi, pcfg)
        mark("forward")
        sum(losses.values()).backward()
        mesh_utils.sum_gradients(state.model.parameters(), group)
        mark("backward")
        state.optimizer.step()
        state.step += 1
        mark("update")
        return state, finish_losses(losses)

    return in_step_group(group, train_step)


class OracleTrainer(DetectorTrainerBase):
    """Supervised training on ``DATASETS.TRAIN_UNLABEL[0]``'s ground truth
    on ``device``: eval every ``TEST.EVAL_PERIOD`` steps into ``ap_50``, a
    checkpoint every ``SOLVER.CHECKPOINT_PERIOD``."""

    def __init__(self, cfg, class_tokens: Optional[np.ndarray] = None,
                 device="cuda"):
        super().__init__(cfg, class_tokens, device=device)
        self.state = init_oracle_state(self.cfg, self.model, self.cfg.SEED)
        self._train_step = build_oracle_step(self.tokens, self.pcfg,
                                             group=self.group)
        self.ap_50 = {}

    def train(self, max_iter: Optional[int] = None):
        cfg = self.cfg
        dev = self.device
        max_iter = max_iter or cfg.SOLVER.MAX_ITER
        self.replicate()
        it = iter(self.train_loader)
        for i in range(int(self.state.step), max_iter):
            batch = next(it)
            self.state, losses = self._train_step(
                self.state, torch.from_numpy(batch.images).to(dev),
                torch.from_numpy(batch.image_hw).to(dev),
                gt_detections(batch, dev))
            metrics = dict(losses)
            if i % self.metrics.period == 0:
                metrics["lr"] = lr_value(self.state.optimizer.schedule, i)
            self.metrics.log(i, metrics)
            if (i + 1) % cfg.TEST.EVAL_PERIOD == 0:
                self.ap_50[i] = self.test()["AP50"]
            if (i + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
                self.checkpointer.save(self.state, i + 1)
        self.metrics.close()
        return self.state

    def test(self) -> Dict[str, float]:
        return self.evaluate(self.state.model)

    def resume_or_load(self, resume: bool = False):
        """``resume``: the latest checkpoint of OUTPUT_DIR, whole; without
        it nothing is loaded, as in the JAX package."""
        if resume:
            self.checkpointer.load_latest(self.state)
        self.replicate()
