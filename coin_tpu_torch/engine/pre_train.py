"""The pre-train stage, knowledge dissemination (counterpart of
coin_tpu/engine/pre_train.py): CLIPDET trains on the cloud detector's
cached, CLIP-re-scored detections (``CLIP_collect.npz``), which arrive
packed on each batch (``TrainLoader(store=...)``).

One step, in order: the strong and the weak view of the batch (K4, both
views) → both views trained as 2B images, the detections tiled → the
pre-train losses (``coin_pipelines.pretrain_losses``) and their backward
→ one ``ScheduledSGD`` step → the prototype EMA, from
``CLOUD.PROTOTYPE_UPDATE_START`` on. Random draws (the strong view's
values and the RPN and ROI subsampling priorities) come from the state's
generator, or from the caller as a ``step_builder.StepDraws`` whose
``rpn`` and ``roi`` rows are the 2B trained images'.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from coin_tpu_torch.data.augment import preprocess_batch
from coin_tpu_torch.data.loader import TrainLoader
from coin_tpu_torch.device import resolve_device
from coin_tpu_torch.engine import coin_pipelines, pipelines
from coin_tpu_torch.engine.base import (DetectorTrainerBase,
                                        load_collect_store, rank_kw,
                                        scaled_cfg)
from coin_tpu_torch.engine.common import lr_value
from coin_tpu_torch.engine.results_store import ResultStore
from coin_tpu_torch.engine.state import (Prototypes, TrainState,
                                         default_freeze_predicate, freeze,
                                         trainable)
from coin_tpu_torch.engine.step_builder import (StepDraws, draw_step,
                                                 finish_losses, in_step_group,
                                                 num_anchors, shard_draws)
from coin_tpu_torch.parallel import mesh_utils
from coin_tpu_torch.solver import build_optimizer
from coin_tpu_torch.structures import Detections


def online_view_to_detections(view: Dict[str, np.ndarray],
                              device="cuda") -> Detections:
    """A packed store view (``ResultStore.pack_view`` arrays, batched) →
    Detections on ``device`` (the card unless the caller passes
    ``device="cpu"``)."""
    device = resolve_device(device)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    return Detections(boxes=t(view["boxes"]), scores=t(view["scores"]),
                      classes=t(view["classes"]), valid=t(view["valid"]),
                      probs=t(view["probs"]))


def init_pretrain_state(cfg, model, seed: int,
                        proto0: torch.Tensor) -> TrainState:
    """The pre-train state at step 0 for ``model`` (already holding its
    weights): the freeze set of ``MODEL.BACKBONE.FREEZE_AT`` and
    ``CLOUD.UPDATE_BACKBONE``, the optimizer, the three prototypes at
    ``proto0`` (only ``proto`` moves here), no teacher and no CKG. The
    step's generator lives on the model's device, seeded ``seed + 1``."""
    dev = next(model.parameters()).device
    freeze(model, default_freeze_predicate(
        cfg.CLOUD.UPDATE_BACKBONE, cfg.MODEL.BACKBONE.FREEZE_AT))
    return TrainState(
        model=model, teacher=None, merge_model=None,
        optimizer=build_optimizer(trainable(model), cfg),
        merge_optimizer=None,
        prototypes=Prototypes(proto0.clone(), proto0.clone(),
                              proto0.clone()),
        step=0,
        generator=torch.Generator(device=dev).manual_seed(seed + 1))


def build_pretrain_step(class_tokens: torch.Tensor,
                        pcfg: pipelines.PipelineConfig,
                        prototype_rate: float, prob_weighted: bool,
                        loss_weights: Optional[Dict[str, float]] = None,
                        on_stage: Optional[Callable[[str], None]] = None,
                        group=None):
    """``train_step(state, images_u8, image_hw, rcnn, rpn,
    update_prototype, draws=None) -> (state, losses)``: uint8 images
    (B, H, W, 3) and the batched cloud views (RCNN and RPN, with probs) on
    the model's device; ``state`` is updated in place and returned;
    ``losses`` are the weighted, detached scalars. ``on_stage(name)``, when
    given, is called as each stage ends: "augment", "forward",
    "backward", "update". With a ``group`` of more than one rank each
    rank passes its shard of the global batch (``draws``, when given, are
    the global batch's): the step is data-parallel, as the adaptation
    step (``step_builder``)."""
    mark = on_stage or (lambda stage: None)

    def train_step(state: TrainState, images_u8, image_hw, rcnn: Detections,
                   rpn: Detections, update_prototype: bool,
                   draws: Optional[StepDraws] = None):
        b, hh, ww, _ = images_u8.shape
        if draws is None:
            draws = draw_step(state.generator, mesh_utils.global_batch(b),
                              num_anchors(pcfg, hh, ww),
                              pcfg.post_nms_topk_train + rcnn.capacity,
                              views=2)
        draws = shard_draws(draws, group, views=2)
        strong, weak = preprocess_batch(images_u8, draws.augment)
        mark("augment")
        tile = lambda t: torch.cat([t, t], 0)
        state.optimizer.zero_grad()
        losses, new_proto = coin_pipelines.pretrain_losses(
            state.model, torch.cat([strong, weak], 0), tile(image_hw),
            rcnn.map(tile), rpn.map(tile), state.prototypes.proto,
            class_tokens, draws.rpn, draws.roi, pcfg, update_prototype,
            prototype_rate, prob_weighted, loss_weights)
        mark("forward")
        sum(losses.values()).backward()
        mesh_utils.sum_gradients(state.model.parameters(), group)
        mark("backward")
        state.optimizer.step()
        p = state.prototypes
        state.prototypes = Prototypes(new_proto, p.b_online, p.b_offline)
        state.step += 1
        mark("update")
        return state, finish_losses(losses)

    return in_step_group(group, train_step)


class PRETrainer(DetectorTrainerBase):
    """CLIPDET pre-training from ``CLOUD.COLLECT_FILE`` (or ``store``) on
    ``device``. Clipart (``DATASETS.TRAIN_UNLABEL`` ``cliparttrain``)
    trains on the rows scoring 0.5 or more with the probability-weighted
    class loss."""

    def __init__(self, cfg, store: Optional[ResultStore] = None,
                 class_tokens: Optional[np.ndarray] = None, device="cuda"):
        device = resolve_device(device)
        cfg = scaled_cfg(cfg)
        if store is None:
            store = load_collect_store(cfg, "PRETrainer")
        clipart = tuple(cfg.DATASETS.TRAIN_UNLABEL) == ("cliparttrain",)
        loader = TrainLoader(
            cfg.DATASETS.TRAIN_UNLABEL[0], cfg.DATASETS.ROOT,
            batch_size=cfg.SOLVER.IMG_PER_BATCH_UNLABEL, seed=cfg.SEED,
            min_size=cfg.INPUT.MIN_SIZE_TRAIN, max_size=cfg.INPUT.MAX_SIZE,
            store=store, store_cap=cfg.get_path("TPU.CAP_TEACHER", 128),
            store_thresh=0.5 if clipart else None, **rank_kw())
        super().__init__(cfg, class_tokens, train_loader=loader,
                         device=device)
        self.store = store
        self.prob_weighted = clipart
        self.state = init_pretrain_state(cfg, self.model, cfg.SEED,
                                         proto0=self.init_prototypes())
        self._train_step = build_pretrain_step(
            self.tokens, self.pcfg, cfg.CLOUD.PROTOTYPE_UPDATE_WEIGHT,
            clipart, self.loss_weights, group=self.group)
        self.ap_50 = {}

    def train(self, max_iter: Optional[int] = None):
        cfg = self.cfg
        dev = self.device
        max_iter = max_iter or cfg.SOLVER.MAX_ITER
        self.replicate()
        it = iter(self.train_loader)
        start = int(self.state.step)
        upd_start = cfg.CLOUD.PROTOTYPE_UPDATE_START
        view = lambda v: online_view_to_detections(v, dev)
        for i in range(start, max_iter):
            batch = next(it)
            update_prototype = upd_start != -1 and i >= upd_start
            self.state, losses = self._train_step(
                self.state, torch.from_numpy(batch.images).to(dev),
                torch.from_numpy(batch.image_hw).to(dev),
                view(batch.online["RCNN"]), view(batch.online["RPN"]),
                update_prototype)
            metrics = dict(losses)
            if i % self.metrics.period == 0:
                metrics["lr"] = lr_value(self.state.optimizer.schedule, i)
            self.metrics.log(i, metrics)
            if (i + 1) % cfg.TEST.EVAL_PERIOD == 0:
                self.ap_50[i] = self.test()["AP50"]
            if (i + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
                self.checkpointer.save(self.state, i + 1)
        self.checkpointer.save(self.state, max_iter,
                               name=f"pre_train_CLIP_{max_iter:07d}")
        self.metrics.close()
        return self.state

    def test(self) -> Dict[str, float]:
        return self.evaluate(self.state.model)

    def resume_or_load(self, resume: bool = False):
        """``resume``: the latest checkpoint of OUTPUT_DIR, whole."""
        if resume:
            self.checkpointer.load_latest(self.state)
        self.replicate()
