"""Eval-only trainers (counterpart of coin_tpu/engine/test.py).

- ``StoreEvalTrainer`` evaluates a collected ResultStore's view against a
  dataset's ground truth (the collector's ``test()``,
  gdino_collector.py:88-92).
- ``CloudLiveEvalTrainer`` runs the cloud teacher live over
  ``DATASETS.TEST`` and evaluates VOC AP (the reference's
  GDINOTrainer.test, coin/engine/test.py:72-102); ``TPU.SYNTHETIC_TEACHER``
  swaps in the random-weight rehearsal detector.
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import torch

from coin_tpu_torch.data.loader import TestLoader
from coin_tpu_torch.data.voc import get_dataset, load_voc_instances
from coin_tpu_torch.device import resolve_device
from coin_tpu_torch.engine.results_store import ResultStore
from coin_tpu_torch.evaluation import VOCEvaluator

logger = logging.getLogger(__name__)


def _records(cfg, spec):
    return load_voc_instances(os.path.join(cfg.DATASETS.ROOT, spec.dirname),
                              spec.split, spec.class_names, spec.image_ext)


class StoreEvalTrainer:
    """Evaluate a ResultStore's RCNN view against a VOC dataset."""

    def __init__(self, cfg, view: str = "RCNN"):
        self.cfg = cfg
        self.view = view
        path = cfg.get_path("CLOUD.COLLECT_FILE", "")
        if not path or not os.path.exists(path):
            raise FileNotFoundError(
                "StoreEvalTrainer needs CLOUD.COLLECT_FILE pointing at a "
                "collected ResultStore (.npz)")
        self.store = ResultStore.load(path)

    def resume_or_load(self, resume: bool = False):
        pass

    def test(self) -> Dict[str, float]:
        spec = get_dataset(self.cfg.DATASETS.TEST[0])
        records = _records(self.cfg, spec)
        evaluator = VOCEvaluator(spec.class_names)
        missing = 0
        for rec in records:
            if rec["image_id"] not in self.store:
                missing += 1
                continue
            view = self.store.get_view(rec["image_id"], self.view)
            evaluator.process(rec["image_id"], view["boxes"],
                              view["scores"], view["classes"],
                              rec["boxes"], rec["classes"],
                              rec["difficult"])
        if missing:
            logger.warning("%d/%d images missing from the store", missing,
                           len(records))
        return evaluator.evaluate()


class CloudLiveEvalTrainer:
    """Run the cloud teacher live over ``DATASETS.TEST`` at the teacher's
    input sizes (INPUT.TEACHER_CLOUD.*) and evaluate VOC AP; no collected
    store is needed."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def resume_or_load(self, resume: bool = False):
        pass

    def test(self) -> Dict[str, float]:
        from coin_tpu_torch.engine.cloud_factory import (
            build_cloud_detector, build_synthetic_detector)
        cfg = self.cfg
        name = cfg.DATASETS.TEST[0]
        spec = get_dataset(name)
        tc = cfg.INPUT.TEACHER_CLOUD
        loader = TestLoader(
            name, cfg.DATASETS.ROOT,
            batch_size=cfg.get_path("TEST.IMS_PER_BATCH", 4),
            min_size=tc.MIN_SIZE_TEST,
            max_size=cfg.get_path("INPUT.TEACHER_CLOUD.MAX_SIZE_TEST",
                                  cfg.INPUT.MAX_SIZE))
        if cfg.get_path("TPU.SYNTHETIC_TEACHER", False):
            detector = build_synthetic_detector(spec.class_names, self.device)
        else:
            detector = build_cloud_detector(
                cfg, cfg.MODEL.TEACHER_CLOUD.META_ARCHITECTURE,
                spec.class_names, self.device)
        records = {rec["image_id"]: rec for rec in _records(cfg, spec)}
        evaluator = VOCEvaluator(spec.class_names)
        for batch, n_valid in loader:
            with torch.no_grad():
                dets = detector(
                    torch.from_numpy(batch.images).to(self.device),
                    torch.from_numpy(batch.image_hw).to(self.device))
            dets = dets.map(lambda t: t.cpu().numpy())
            for i in range(n_valid):
                rec = records[batch.image_ids[i]]
                valid = dets.valid[i]
                evaluator.process(
                    rec["image_id"], dets.boxes[i][valid] / batch.scale[i],
                    dets.scores[i][valid], dets.classes[i][valid],
                    rec["boxes"], rec["classes"], rec["difficult"])
        return evaluator.evaluate()


def build_eval_trainer(cfg, name: str, device="cuda"):
    """GDINO_test / GLIP_test: a collected store (CLOUD.COLLECT_FILE)
    evaluates directly, otherwise the cloud teacher runs live; CLIP_test
    evaluates a re-scored store."""
    if name in ("GDINO_test", "GLIP_test"):
        path = cfg.get_path("CLOUD.COLLECT_FILE", "")
        if path and os.path.exists(path):
            return StoreEvalTrainer(cfg)
        return CloudLiveEvalTrainer(cfg, device)
    if name == "CLIP_test":
        return StoreEvalTrainer(cfg)
    raise ValueError(name)
