"""CoinTrainer, the dual-teacher adaptation stage (counterpart of
coin_tpu/engine/trainer.py).

The loop of ``train`` is the JAX trainer's: before burn-up, when the phase
is long enough (``TPU.CACHE_TEACHER_MIN_STEPS``), the frozen teacher's
predictions come from one collection pass (``train_step_cached``); after
burn-up, with ``TPU.TEACHER_REFRESH_EPOCHS`` set, from a collection pass
repeated every that many epochs (``train_step_cached_two``); otherwise the
live teacher runs in every step (``train_step``). The collection pass runs
the teacher over the train set in both orientations and keeps its
detections in canvas coordinates; under ``TPU.INT8_COLLECT`` it runs the
teacher's int8 clone (K2s in every conv, sharing the teacher's weights).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from coin_tpu_torch.data.augment import normalize_batch
from coin_tpu_torch.data.loader import TestLoader, TrainLoader
from coin_tpu_torch.device import resolve_device
from coin_tpu_torch.engine import pipelines
from coin_tpu_torch.engine.base import (NUM_WORKERS, DetectorTrainerBase,
                                        auto_scale_workers, check_ported)
from coin_tpu_torch.engine.common import lr_value
from coin_tpu_torch.engine.pre_train import online_view_to_detections
from coin_tpu_torch.engine.results_store import ResultStore
from coin_tpu_torch.engine.step_builder import (build_adaptation_steps,
                                                hyper_from_cfg,
                                                init_train_state)

logger = logging.getLogger(__name__)


class CoinTrainer(DetectorTrainerBase):
    def __init__(self, cfg, store: Optional[ResultStore] = None,
                 class_tokens: Optional[np.ndarray] = None, device="cuda"):
        device = resolve_device(device)
        cfg = auto_scale_workers(cfg, NUM_WORKERS)
        check_ported(cfg)
        if store is None:
            store = self._load_store(cfg)
        loader = TrainLoader(
            cfg.DATASETS.TRAIN_UNLABEL[0], cfg.DATASETS.ROOT,
            batch_size=cfg.SOLVER.IMG_PER_BATCH_UNLABEL, seed=cfg.SEED,
            min_size=cfg.INPUT.MIN_SIZE_TRAIN, max_size=cfg.INPUT.MAX_SIZE,
            store=store, store_cap=cfg.get_path("TPU.CAP_TEACHER", 128))
        super().__init__(cfg, class_tokens, train_loader=loader,
                         device=device)
        self.store = store
        self.state = init_train_state(cfg, self.model, self.tokens, cfg.SEED,
                                      proto0=self.init_prototypes())
        # the teacher's proposal budget (TPU.TEACHER_PRE/POST_NMS_TOPK) and
        # its res5-crop sharing (TPU.TEACHER_SHARE_CROPS/SHARE_THRESH)
        self.teacher_pcfg = dataclasses.replace(
            self.pcfg,
            pre_nms_topk_test=cfg.get_path("TPU.TEACHER_PRE_NMS_TOPK",
                                           self.pcfg.pre_nms_topk_test),
            post_nms_topk_test=cfg.get_path("TPU.TEACHER_POST_NMS_TOPK",
                                            self.pcfg.post_nms_topk_test),
            share_crops_budget=cfg.get_path("TPU.TEACHER_SHARE_CROPS", 0),
            share_crops_thresh=cfg.get_path("TPU.TEACHER_SHARE_THRESH",
                                            0.9))
        hyper = dataclasses.replace(hyper_from_cfg(cfg),
                                    loss_weights=self.loss_weights)
        self._refresh_epochs = cfg.get_path("TPU.TEACHER_REFRESH_EPOCHS", 0)
        (self._train_step, self._train_step_cached,
         self._train_step_cached_two) = build_adaptation_steps(
            self.tokens, self.pcfg, self.teacher_pcfg, hyper)
        self.teacher_store = None
        self._collect_loader = None
        self.ap_50_student = {}
        self.ap_50_offline_teacher = {}

    @staticmethod
    def _load_store(cfg) -> ResultStore:
        path = cfg.get_path("CLOUD.COLLECT_FILE", "")
        if path and os.path.exists(path):
            return ResultStore.load(path)
        raise FileNotFoundError(
            "CoinTrainer needs cached cloud results (CLOUD.COLLECT_FILE)")

    # ------------------------------------------------------------- #
    @torch.no_grad()
    def collect_teacher_store(self) -> ResultStore:
        """The teacher's detections over the unlabeled train set, one pass
        per orientation (the loader flips the valid region on the host, so
        the cache serves flipped samples exactly), in canvas coordinates."""
        if self._collect_loader is None:
            self._collect_loader = TestLoader(
                self.cfg.DATASETS.TRAIN_UNLABEL[0], self.cfg.DATASETS.ROOT,
                batch_size=max(self.cfg.SOLVER.IMG_PER_BATCH_UNLABEL, 4),
                min_size=self.cfg.INPUT.MIN_SIZE_TRAIN,
                max_size=self.cfg.INPUT.MAX_SIZE,
                canvas_hw=self.train_loader.canvas_hw)
        model = self.state.teacher
        if self.cfg.get_path("TPU.INT8_COLLECT", False):
            model = model.clone(quant_convs=True)
        text = model.text_features(self.tokens)
        both = getattr(self.train_loader, "flip", True)
        store = ResultStore(self.num_classes)
        for batch, n_valid in self._collect_loader:
            passes = [("RCNN", batch.images)]
            if both:
                fl = batch.images.copy()
                for i in range(len(fl)):
                    nh, nw = (int(v) for v in batch.image_hw[i])
                    fl[i, :nh, :nw] = fl[i, :nh, :nw][:, ::-1]
                passes.append(("RCNN_FLIP", fl))
            hw = torch.from_numpy(batch.image_hw).to(self.device)
            for view, images in passes:
                images = normalize_batch(
                    torch.from_numpy(images).to(self.device))
                dets = pipelines.inference(model, images, hw, self.tokens,
                                           self.teacher_pcfg,
                                           text_features=text)
                d = {k: getattr(dets, k).cpu().numpy()
                     for k in ("boxes", "classes", "scores", "probs",
                               "valid")}
                for i in range(n_valid):
                    v = d["valid"][i]
                    store.put(batch.image_ids[i], view, d["boxes"][i][v],
                              d["classes"][i][v], d["scores"][i][v],
                              d["probs"][i][v])
        logger.info("cached teacher predictions for %d images%s",
                    len(store), " (both orientations)" if both else "")
        return store

    def _pack_offline(self, batch) -> Dict[str, np.ndarray]:
        """The teacher cache for a train batch (canvas coordinates; flipped
        samples read the RCNN_FLIP view)."""
        cap = self.pcfg.test_topk
        per = []
        for j, image_id in enumerate(batch.image_ids):
            fl = bool(batch.flip[j])
            if fl and not self.teacher_store.has_view(image_id, "RCNN_FLIP"):
                raise RuntimeError(
                    "teacher store lacks the RCNN_FLIP view for flipped "
                    "sample %r; re-collect with flips enabled" % image_id)
            per.append(self.teacher_store.pack_view(
                image_id, "RCNN_FLIP" if fl else "RCNN", cap, 1.0, False,
                0.0))
        return {k: np.stack([p[k] for p in per]) for k in per[0]}

    def train(self, max_iter: Optional[int] = None):
        cfg = self.cfg
        dev = self.device
        max_iter = max_iter or cfg.SOLVER.MAX_ITER
        it = iter(self.train_loader)
        start = int(self.state.step)
        burn_up = cfg.CLOUD.BURN_UP_STEP
        min_steps = cfg.get_path("TPU.CACHE_TEACHER_MIN_STEPS", 500)
        use_cache = (cfg.get_path("TPU.CACHE_TEACHER", True)
                     and burn_up - start >= min_steps)
        if use_cache and self.teacher_store is None:
            self.teacher_store = self.collect_teacher_store()
        refresh_steps = self._refresh_epochs * max(
            len(self.train_loader.records)
            // cfg.SOLVER.IMG_PER_BATCH_UNLABEL, 1)
        last_refresh = None
        view = lambda v: online_view_to_detections(v, dev)
        for i in range(start, max_iter):
            batch = next(it)
            args = (torch.from_numpy(batch.images).to(dev),
                    torch.from_numpy(batch.image_hw).to(dev),
                    view(batch.online["RCNN"]), view(batch.online["RPN"]))
            if use_cache and i < burn_up:
                self.state, losses = self._train_step_cached(
                    self.state, *args, view(self._pack_offline(batch)))
            elif refresh_steps and i >= burn_up:
                if last_refresh is None or i - last_refresh >= refresh_steps:
                    self.teacher_store = self.collect_teacher_store()
                    last_refresh = i
                self.state, losses = self._train_step_cached_two(
                    self.state, *args, view(self._pack_offline(batch)))
            else:
                self.state, losses = self._train_step(self.state, *args)
            metrics = dict(losses)
            if i % self.metrics.period == 0:
                metrics["lr"] = lr_value(self.state.optimizer.schedule, i)
                metrics["merge_lr"] = lr_value(
                    self.state.merge_optimizer.schedule, i)
            self.metrics.log(i, metrics)
            if i == burn_up - 1:
                self.checkpointer.save(self.state, i, name=f"burn_up_{i:07d}")
            if (i + 1) % cfg.TEST.EVAL_PERIOD == 0:
                self.ap_50_student[i] = self.test()["AP50"]
                if i >= burn_up and cfg.CLOUD.EMA_KEEP_RATE_OFFLINE != 1.0:
                    self.ap_50_offline_teacher[i] = \
                        self.test_teacher()["AP50"]
            if (i + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
                self.checkpointer.save(
                    self.state, i + 1,
                    extras={"ap_50_student": self.ap_50_student,
                            "ap_50_offline_teacher":
                                self.ap_50_offline_teacher})
        self.metrics.close()
        return self.state

    def test(self) -> Dict[str, float]:
        return self.evaluate(self.state.model)

    def test_teacher(self) -> Dict[str, float]:
        return self.evaluate(self.state.teacher)

    @torch.no_grad()
    def resume_or_load(self, resume: bool = False):
        """``resume``: the latest checkpoint of OUTPUT_DIR, whole. Otherwise
        MODEL.WEIGHTS: 'ckpt' or 'ckpt+collect.npz' starts fresh from a
        checkpoint's student weights and prototypes (the teacher a copy of
        the student), with the store of the npz."""
        if resume:
            self.checkpointer.load_latest(self.state)
            latest = self.checkpointer.latest_path()
            if latest:
                ex = self.checkpointer.load_extras(latest)
                self.ap_50_student.update(
                    {int(k): v for k, v in ex.get("ap_50_student",
                                                  {}).items()})
                self.ap_50_offline_teacher.update(
                    {int(k): v for k, v in ex.get("ap_50_offline_teacher",
                                                  {}).items()})
            return
        w = self.cfg.MODEL.WEIGHTS
        if not w:
            return
        paths = w.split("+")
        pre = paths[0]
        if len(paths) == 2 and os.path.exists(paths[1]):
            self.store = ResultStore.load(paths[1])
            self.train_loader.store = self.store
            logger.info("loaded collect store from %s", paths[1])
        if os.path.exists(pre):
            raw = self.checkpointer.load_tree(pre)
            self.state.model.load_state_dict(raw["model"])
            self.state.teacher.load_state_dict(raw["model"])
            pr = raw["prototypes"]
            self.state.prototypes = type(self.state.prototypes)(
                *(pr[k].to(self.device)
                  for k in ("proto", "b_online", "b_offline")))
            logger.info("loaded student weights and prototypes from %s", pre)
