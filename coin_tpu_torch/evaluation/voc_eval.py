"""Copy of coin_tpu/evaluation/voc_eval.py (host-only numpy), kept so the
port imports nothing of coin_tpu.

Pascal-VOC detection evaluation.

Numerically identical to the reference evaluator
(coin/evaluation/cloud_pascal_voc_evaluation.py:173-319): inclusive-pixel
IoU (+1), greedy confidence-ordered matching with difficult-box handling,
area-under-PR AP; metrics = AP (mean over IoU 50:5:95), AP50, AP75 and
per-class AP50.

Host-side numpy — evaluation is IO/accumulation-bound, not a TPU workload.
Detections arrive as per-image arrays of the valid rows; the
reference's +1 coordinate convention for dumped predictions is applied here
(its evaluate() writes xmin+1 before voc_eval).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else np.max(prec[rec >= t])
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval_class(dets: Dict[str, List], gts: Dict[str, Dict],
                   ovthresh: float = 0.5,
                   use_07_metric: bool = False) -> float:
    """AP for one class.

    dets: image_id → list of (confidence, box[4]) (boxes already in the +1
    dumped convention).
    gts: image_id → {"bbox": (n,4), "difficult": (n,) bool}.
    """
    npos = 0
    class_recs = {}
    for img, rec in gts.items():
        difficult = np.asarray(rec["difficult"], bool)
        npos += int((~difficult).sum())
        class_recs[img] = {
            "bbox": np.asarray(rec["bbox"], float).reshape(-1, 4),
            "difficult": difficult,
            "det": [False] * len(difficult),
        }

    flat = []
    for img, items in dets.items():
        for conf, box in items:
            flat.append((img, conf, box))
    if not flat:
        return 0.0
    flat.sort(key=lambda t: -t[1])

    tp = np.zeros(len(flat))
    fp = np.zeros(len(flat))
    for d, (img, _, bb) in enumerate(flat):
        r = class_recs.get(img)
        ovmax, jmax = -np.inf, -1
        if r is not None and r["bbox"].size > 0:
            gt = r["bbox"]
            ixmin = np.maximum(gt[:, 0], bb[0])
            iymin = np.maximum(gt[:, 1], bb[1])
            ixmax = np.minimum(gt[:, 2], bb[2])
            iymax = np.minimum(gt[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inters = iw * ih
            uni = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                   + (gt[:, 2] - gt[:, 0] + 1.0)
                   * (gt[:, 3] - gt[:, 1] + 1.0) - inters)
            overlaps = inters / uni
            ovmax = overlaps.max()
            jmax = int(overlaps.argmax())
        if ovmax > ovthresh:
            if not r["difficult"][jmax]:
                if not r["det"][jmax]:
                    tp[d] = 1.0
                    r["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return voc_ap(rec, prec, use_07_metric)


class VOCEvaluator:
    """Accumulates per-image predictions + ground truth, computes
    AP/AP50/AP75 + per-class AP50 (reference evaluate(),
    cloud_pascal_voc_evaluation.py:93-128)."""

    def __init__(self, class_names: Sequence[str]):
        self.class_names = list(class_names)
        self.reset()

    def reset(self):
        self._dets = defaultdict(lambda: defaultdict(list))
        self._gts = defaultdict(dict)

    def process(self, image_id: str, pred_boxes: np.ndarray,
                pred_scores: np.ndarray, pred_classes: np.ndarray,
                gt_boxes: np.ndarray, gt_classes: np.ndarray,
                gt_difficult: np.ndarray = None):
        """Boxes in original-image xyxy (0-based); the +1 dump convention is
        applied internally (reference writes xmin+1 ymin+1 xmax+1 ymax+1)."""
        if gt_difficult is None:
            gt_difficult = np.zeros(len(gt_boxes), bool)
        for ci, cname in enumerate(self.class_names):
            sel = pred_classes == ci
            for box, score in zip(pred_boxes[sel] + 1.0, pred_scores[sel]):
                self._dets[cname][image_id].append((float(score), box))
            gsel = gt_classes == ci
            self._gts[cname][image_id] = {
                "bbox": gt_boxes[gsel] + 1.0,
                "difficult": gt_difficult[gsel],
            }

    def evaluate(self) -> Dict[str, float]:
        aps = defaultdict(list)  # iou → per-class list
        for cname in self.class_names:
            for thresh in range(50, 100, 5):
                ap = voc_eval_class(self._dets[cname], self._gts[cname],
                                    ovthresh=thresh / 100.0)
                aps[thresh].append(ap * 100.0)
        result = {
            "AP": float(np.mean([np.mean(v) for v in aps.values()])),
            "AP50": float(np.mean(aps[50])),
            "AP75": float(np.mean(aps[75])),
        }
        for cname, ap in zip(self.class_names, aps[50]):
            result[f"AP50-{cname}"] = float(ap)
        return result
