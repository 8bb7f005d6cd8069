"""Evaluation loop: batched inference on the device + host-side VOC
accumulation (counterpart of coin_tpu/engine/evaluator.py:48-77). A
loader sharded over a process group (``TestLoader(rank=, world=)``) runs
its whole batches on each rank; the detections are gathered to every
rank in the single-process order, so the AP is the single-process AP."""

from __future__ import annotations

import logging
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from coin_tpu_torch.data.augment import normalize_batch
from coin_tpu_torch.data.loader import TestLoader
from coin_tpu_torch.engine import pipelines
from coin_tpu_torch.evaluation import VOCEvaluator
from coin_tpu_torch.evaluation.dump import save_detections_pkl
from coin_tpu_torch.parallel.multihost import all_gather_objects

logger = logging.getLogger(__name__)


@torch.inference_mode()
def evaluate_detector(model, params: Mapping[str, torch.Tensor],
                      loader: TestLoader, class_tokens: np.ndarray,
                      cfg: pipelines.PipelineConfig,
                      save_pkl: Optional[str] = None) -> Dict[str, float]:
    """Load ``params`` (a state_dict, e.g. the EMA teacher's) into
    ``model``, run inference over ``loader`` on the model's device and
    return {"AP", "AP50", "AP75", "AP50-<class>"...}; with ``save_pkl``,
    also pickle the detections there (``evaluation.dump``)."""
    model.load_state_dict(params)
    model.eval()
    device = next(model.parameters()).device
    tokens = torch.as_tensor(class_tokens, device=device)
    # the text features depend on the weights only: once per evaluation
    text = model.text_features(tokens)

    evaluator = VOCEvaluator(loader.spec.class_names)
    rows = []   # (first index of the batch, image in it, process args)
    for batch, n_valid in loader:
        images = normalize_batch(
            torch.from_numpy(batch.images).to(device, non_blocking=True))
        image_hw = torch.from_numpy(batch.image_hw).to(device)
        dets = pipelines.inference(model, images, image_hw, tokens, cfg,
                                   text_features=text)
        boxes_all = dets.boxes.cpu().numpy()
        scores_all = dets.scores.cpu().numpy()
        classes_all = dets.classes.cpu().numpy()
        valid_all = dets.valid.cpu().numpy()
        for i in range(n_valid):
            valid = valid_all[i]
            gt_valid = batch.gt_valid[i]
            rows.append((int(batch.indices[0]), i, (
                batch.image_ids[i], boxes_all[i][valid] / batch.scale[i],
                scores_all[i][valid], classes_all[i][valid],
                batch.gt_boxes[i][gt_valid] / batch.scale[i],
                batch.gt_classes[i][gt_valid],
                batch.gt_difficult[i][gt_valid])))
    if getattr(loader, "world", 1) > 1:
        rows = sorted((r for part in all_gather_objects(rows) for r in part),
                      key=lambda r: r[:2])
    for _, _, args in rows:
        evaluator.process(*args)
    if save_pkl:
        save_detections_pkl(evaluator, save_pkl)
        logger.info("dumped detections to %s", save_pkl)
    results = evaluator.evaluate()
    logger.info("eval: AP50=%.2f AP=%.2f", results["AP50"], results["AP"])
    return results
