"""Shared trainer base (counterpart of coin_tpu/engine/base.py:73-251): the
detector a config describes, its pipeline configuration and loss weights,
the loaders, evaluation, checkpointing and metrics.

Data parallel: in a process group of W ranks (``parallel/mesh_utils``,
one process per card) a trainer is one rank. Its loader yields the rank's
shard of each global batch, its steps reduce over the group, the state is
broadcast from rank 0 (``replicate_state``) before training and after a
load, evaluation takes whole batches in turn and gathers the detections,
and only rank 0 writes checkpoints and metrics. ``pipeline_config_from``
and ``loss_weights_from`` stay in ``engine/pipelines.py``.
"""

from __future__ import annotations

import logging
import os
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
from coin_tpu_torch.engine.results_store import ResultStore
from coin_tpu_torch.parallel import mesh_utils, multihost

logger = logging.getLogger(__name__)

def load_collect_store(cfg, trainer: str) -> ResultStore:
    """The cached cloud results that ``CLOUD.COLLECT_FILE`` names (a
    ResultStore .npz), for ``trainer``."""
    path = cfg.get_path("CLOUD.COLLECT_FILE", "")
    if path and os.path.exists(path):
        logger.info("loading collect store: %s", path)
        return ResultStore.load(path)
    raise FileNotFoundError(
        f"{trainer} needs cached cloud results: set CLOUD.COLLECT_FILE to "
        f"a ResultStore .npz (written by the collection pass) or pass "
        f"store=")


def num_workers() -> int:
    """The trainer's workers: the ranks of the process group (1 without
    one). A visible card that no rank uses is not a worker, so
    ``auto_scale_workers`` scales for this count, not for
    ``torch.cuda.device_count()``."""
    return multihost.process_count()


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


def scaled_cfg(cfg):
    """``cfg`` after ``auto_scale_workers`` for the process group's ranks,
    checked to give every rank a shard of the batch."""
    cfg = auto_scale_workers(cfg, num_workers())
    mesh_utils.check_batch(cfg.SOLVER.IMG_PER_BATCH_UNLABEL, num_workers())
    return cfg


def rank_kw() -> dict:
    """A loader's shard of the process group: its rank and world size."""
    return {"rank": multihost.process_index(),
            "world": multihost.process_count()}


@torch.no_grad()
def replicate_state(state, group) -> None:
    """Rank 0's train state on every rank of ``group``, in place: the
    student, teacher and CKG net (parameters and buffers), both
    optimizers' momentum, the prototypes, the step and the generator."""
    if mesh_utils.world_size(group) == 1:
        return
    for m in (state.model, state.teacher, state.merge_model):
        if m is not None:
            mesh_utils.replicate(m, group)
    for opt in (state.optimizer, state.merge_optimizer):
        if opt is not None:
            mesh_utils.broadcast_tensors(
                [b for b in opt.momentum_buffers().values()
                 if b is not None], group)
    p = state.prototypes
    if p is not None:
        mesh_utils.broadcast_tensors([p.proto, p.b_online, p.b_offline],
                                     group)
    meta = [int(state.step), state.generator.get_state(),
            int(state.optimizer.count),
            None if state.merge_optimizer is None
            else int(state.merge_optimizer.count)]
    torch.distributed.broadcast_object_list(meta, 0, group=group)
    state.step = meta[0]
    state.generator.set_state(meta[1])
    state.optimizer.count = meta[2]
    if state.merge_optimizer is not None:
        state.merge_optimizer.count = meta[3]


class DetectorTrainerBase:
    """The detector (random weights from ``cfg.SEED``, then OpenAI CLIP's
    under TPU.CLIP_WEIGHTS; f32 masters, int8 res5 under TPU.INT8_TRAIN),
    its class tokens (CLIP BPE prompts under TPU.CLIP_BPE_VOCAB), the
    pipeline configuration, the loss weights, the checkpointer and the
    metric logger, on ``device``; one rank of the process group, if there
    is one (``group``: the group its steps reduce over, None for one
    process)."""

    def __init__(self, cfg, class_tokens: Optional[np.ndarray] = None,
                 train_loader: Optional[TrainLoader] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        cfg = scaled_cfg(cfg)
        self.cfg = cfg
        self.group = mesh_utils.train_group()
        self.is_main = multihost.is_main_process()
        self.train_loader = train_loader or TrainLoader(
            cfg.DATASETS.TRAIN_UNLABEL[0], cfg.DATASETS.ROOT,
            batch_size=cfg.SOLVER.IMG_PER_BATCH_UNLABEL, seed=cfg.SEED,
            min_size=cfg.INPUT.MIN_SIZE_TRAIN, max_size=cfg.INPUT.MAX_SIZE,
            **rank_kw())
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
        self.checkpointer = Checkpointer(cfg.OUTPUT_DIR, write=self.is_main)
        self.metrics = MetricLogger(
            cfg.OUTPUT_DIR, cfg.SOLVER.MAX_ITER,
            tensorboard=cfg.get_path("TPU.TENSORBOARD", False),
            write=self.is_main)
        self._eval_loader = None

    def replicate(self) -> None:
        """Rank 0's state on every rank (a no-op for one process)."""
        replicate_state(self.state, self.group)

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
        weights. Under TEST.SAVE_DETECTION_PKLS the detections are also
        pickled to ``OUTPUT_DIR/detections.pckl``."""
        if self._eval_loader is None:
            self._eval_loader = TestLoader(
                self.cfg.DATASETS.TEST[0], self.cfg.DATASETS.ROOT,
                batch_size=max(self.cfg.SOLVER.IMG_PER_BATCH_UNLABEL, 4),
                min_size=self.cfg.INPUT.MIN_SIZE_TEST,
                max_size=self.cfg.INPUT.MAX_SIZE,
                canvas_hw=self.train_loader.canvas_hw, **rank_kw())
        save_pkl = (os.path.join(self.cfg.OUTPUT_DIR, "detections.pckl")
                    if self.cfg.get_path("TEST.SAVE_DETECTION_PKLS", False)
                    and multihost.is_main_process() else None)
        if self.cfg.get_path("TPU.INT8_INFERENCE", False):
            model = model.clone(quant_convs=True)
        return evaluate_detector(model, model.state_dict(),
                                 self._eval_loader, self.class_tokens,
                                 self.pcfg, save_pkl=save_pkl)
