"""Detection dumps and the AP of a dump (the port's copy of
coin_tpu/evaluation/dump.py).

- ``save_detections_pkl``, under ``TEST.SAVE_DETECTION_PKLS``: pickles
  {class_name: {image_id: [[conf, x1, y1, x2, y2], ...]}} from a
  ``VOCEvaluator`` in the reference's dumped (+1) coordinates, so that the
  file can stand in for the reference's and the JAX package's
  ``detections.pckl``.
- ``evaluate_pkl``: the VOC AP of such a pickle (the port's, the JAX
  package's or the reference's) against a dataset's ground truth.
"""

from __future__ import annotations

import os
import pickle
from collections import defaultdict
from typing import Dict, Sequence

import numpy as np

from coin_tpu_torch.evaluation.voc_eval import VOCEvaluator, voc_eval_class


def save_detections_pkl(evaluator: VOCEvaluator, path: str) -> str:
    payload = {}
    for cname in evaluator.class_names:
        payload[cname] = {
            img: [[conf, *box.tolist()] for conf, box in items]
            for img, items in evaluator._dets[cname].items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path


def evaluate_pkl(pkl_path: str, records: Sequence[dict],
                 class_names: Sequence[str]) -> Dict[str, float]:
    """AP, AP50, AP75 and AP50 per class of a detection pickle; records:
    VOC dicts from ``data.voc.load_voc_instances`` (0-based boxes). The
    pickle is unpickled, so read only files that this program, the JAX
    package or the reference wrote."""
    with open(pkl_path, "rb") as f:
        payload = pickle.load(f)
    aps = defaultdict(list)
    for ci, cname in enumerate(class_names):
        dets = {img: [(row[0], np.asarray(row[1:5], float))
                      for row in rows]
                for img, rows in payload.get(cname, {}).items()}
        gts = {}
        for rec in records:
            sel = rec["classes"] == ci
            gts[rec["image_id"]] = {
                "bbox": rec["boxes"][sel] + 1.0,
                "difficult": rec["difficult"][sel],
            }
        for thresh in range(50, 100, 5):
            aps[thresh].append(
                voc_eval_class(dets, gts, thresh / 100.0) * 100.0)
    out = {
        "AP": float(np.mean([np.mean(v) for v in aps.values()])),
        "AP50": float(np.mean(aps[50])),
        "AP75": float(np.mean(aps[75])),
    }
    for cname, ap in zip(class_names, aps[50]):
        out[f"AP50-{cname}"] = float(ap)
    return out
