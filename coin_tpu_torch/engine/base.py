"""Shared trainer base (counterpart of coin_tpu/engine/base.py:73-251): the
detector a config describes, its pipeline configuration and loss weights,
the loaders, evaluation, checkpointing and metrics.

This slice runs on one device: the JAX package's data mesh
(``shard_batch``, ``replicate_state``) has no counterpart until ROADMAP
item 22. ``pipeline_config_from`` and ``loss_weights_from`` stay in
``engine/pipelines.py``.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from coin_tpu_torch.data.loader import TestLoader, TrainLoader
from coin_tpu_torch.device import resolve_device
from coin_tpu_torch.engine import pipelines
from coin_tpu_torch.engine.checkpoint import Checkpointer
from coin_tpu_torch.engine.clip_setup import (load_clip_into_model,
                                              setup_clip_assets,
                                              template_prototypes)
from coin_tpu_torch.engine.common import MetricLogger
from coin_tpu_torch.engine.evaluator import evaluate_detector

logger = logging.getLogger(__name__)

# TPU.* knobs the JAX trainers honour whose code the port does not have yet
# (a knob that is set and not honoured would train another recipe silently)
_NOT_PORTED = {
    "TPU.TEACHER_FAST_HEAD": "the teacher's fast head (pool_boxes_fast)",
    "TEST.SAVE_DETECTION_PKLS": "detection pickles of the evaluator",
}


def check_ported(cfg) -> None:
    """Raise NotImplementedError for a set knob of :data:`_NOT_PORTED`."""
    for key, what in _NOT_PORTED.items():
        if cfg.get_path(key, None):
            raise NotImplementedError(f"{key} is set, but {what} is not "
                                      f"ported yet")


# the port trains on one device until the data-parallel trainer (ROADMAP
# item 22): a visible card that it does not use is not a worker, so
# ``auto_scale_workers`` scales for this count, not for
# ``torch.cuda.device_count()``
NUM_WORKERS = 1


def auto_scale_workers(cfg, num_workers: int):
    """detectron2's ``DefaultTrainer.auto_scale_workers``: when
    ``SOLVER.REFERENCE_WORLD_SIZE`` is set and differs from the number of
    workers, rescale the batch and LR linearly and the schedule inversely.
    Returns a new cfg; a no-op at the reference value 0."""
    old = cfg.SOLVER.REFERENCE_WORLD_SIZE
    if old == 0 or old == num_workers:
        return cfg
    cfg = cfg.clone()
    scale = num_workers / old
    cfg.SOLVER.IMG_PER_BATCH_UNLABEL = int(
        round(cfg.SOLVER.IMG_PER_BATCH_UNLABEL * scale))
    cfg.SOLVER.BASE_LR = cfg.SOLVER.BASE_LR * scale
    cfg.SOLVER.MAX_ITER = int(round(cfg.SOLVER.MAX_ITER / scale))
    cfg.SOLVER.WARMUP_ITERS = int(round(cfg.SOLVER.WARMUP_ITERS / scale))
    cfg.SOLVER.STEPS = [int(round(s / scale)) for s in cfg.SOLVER.STEPS]
    cfg.TEST.EVAL_PERIOD = int(round(cfg.TEST.EVAL_PERIOD / scale))
    cfg.SOLVER.CHECKPOINT_PERIOD = int(
        round(cfg.SOLVER.CHECKPOINT_PERIOD / scale))
    cfg.SOLVER.REFERENCE_WORLD_SIZE = num_workers
    logger.info("auto_scale_workers: %d -> %d workers (batch %d, lr %g, "
                "max_iter %d)", old, num_workers,
                cfg.SOLVER.IMG_PER_BATCH_UNLABEL, cfg.SOLVER.BASE_LR,
                cfg.SOLVER.MAX_ITER)
    return cfg


class DetectorTrainerBase:
    """The detector (random weights from ``cfg.SEED``, then OpenAI CLIP's
    under TPU.CLIP_WEIGHTS; f32 masters, int8 res5 under TPU.INT8_TRAIN),
    its class tokens (CLIP BPE prompts under TPU.CLIP_BPE_VOCAB), the
    pipeline configuration, the loss weights, the checkpointer and the
    metric logger, on ``device``."""

    def __init__(self, cfg, class_tokens: Optional[np.ndarray] = None,
                 train_loader: Optional[TrainLoader] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        cfg = auto_scale_workers(cfg, NUM_WORKERS)
        check_ported(cfg)
        self.cfg = cfg
        self.train_loader = train_loader or TrainLoader(
            cfg.DATASETS.TRAIN_UNLABEL[0], cfg.DATASETS.ROOT,
            batch_size=cfg.SOLVER.IMG_PER_BATCH_UNLABEL, seed=cfg.SEED,
            min_size=cfg.INPUT.MIN_SIZE_TRAIN, max_size=cfg.INPUT.MAX_SIZE)
        self.num_classes = len(self.train_loader.spec.class_names)
        if class_tokens is not None:
            self.class_tokens, self.clip_tokenizer = class_tokens, None
        else:
            self.class_tokens, self.clip_tokenizer = setup_clip_assets(
                cfg, self.train_loader.spec.class_names)
        self.tokens = torch.as_tensor(np.asarray(self.class_tokens),
                                      device=self.device).long()
        self.model = pipelines.build_detector(
            cfg, self.num_classes, self.device).random_init(cfg.SEED)
        clip_path = cfg.get_path("TPU.CLIP_WEIGHTS", "")
        if clip_path:
            load_clip_into_model(
                self.model, clip_path, cfg.MODEL.RESNETS.DEPTH,
                region_clip_path=cfg.get_path("TPU.REGION_CLIP_WEIGHTS", ""))
        self.pcfg = pipelines.pipeline_config_from(cfg, self.num_classes)
        self.loss_weights = pipelines.loss_weights_from(cfg)
        self.checkpointer = Checkpointer(cfg.OUTPUT_DIR)
        self.metrics = MetricLogger(
            cfg.OUTPUT_DIR, cfg.SOLVER.MAX_ITER,
            tensorboard=cfg.get_path("TPU.TENSORBOARD", False))
        self._eval_loader = None

    @torch.no_grad()
    def init_prototypes(self) -> torch.Tensor:
        """Template-mean prototypes (C+1, D) when CLIP assets are
        configured, otherwise the learnable-prompt features at init."""
        if self.clip_tokenizer is None:
            return self.model.text_features(self.tokens).float()
        names = list(self.train_loader.spec.class_names) + ["background"]
        proto = template_prototypes(
            lambda t: self.model.text_trunk(t.to(self.device)),
            self.clip_tokenizer, names,
            self.cfg.DATASETS.STYLE_NAME or "realistic")
        return torch.as_tensor(proto, dtype=torch.float32,
                               device=self.device)

    def evaluate(self, model) -> Dict[str, float]:
        """AP of ``model`` (the student or the teacher) on DATASETS.TEST[0];
        under TPU.INT8_INFERENCE through its int8 clone, which shares the
        weights."""
        if self._eval_loader is None:
            self._eval_loader = TestLoader(
                self.cfg.DATASETS.TEST[0], self.cfg.DATASETS.ROOT,
                batch_size=max(self.cfg.SOLVER.IMG_PER_BATCH_UNLABEL, 4),
                min_size=self.cfg.INPUT.MIN_SIZE_TEST,
                max_size=self.cfg.INPUT.MAX_SIZE,
                canvas_hw=self.train_loader.canvas_hw)
        if self.cfg.get_path("TPU.INT8_INFERENCE", False):
            model = model.clone(quant_convs=True)
        return evaluate_detector(model, model.state_dict(),
                                 self._eval_loader, self.class_tokens,
                                 self.pcfg)
