"""Cloud-teacher variants behind the common detector interface
(counterpart of coin_tpu/models/gdino_variants.py).

- ``ClassOnlyAdapter``: GDINO_CLASSONLY (the reference's
  gdino_classonly.py); the cloud gives one-hot class labels and its
  probability vectors are dropped (configs/coin/CLASSONLY/foggy.yaml).
- ``SyntheticProbAdapter``: for teachers that give only (box, class,
  score); probabilities spread 1 − score uniformly over the other classes
  (the reference's gdino1_5API.py:81-85, glip.py:96-105).
- ``GDINO15APIDetector``: the remote Grounding DINO 1.5 teacher needs the
  network and raises.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from coin_tpu_torch.structures import Detections


def one_hot_probs(classes: torch.Tensor, num_classes: int,
                  valid: torch.Tensor) -> torch.Tensor:
    oh = F.one_hot(classes.long().clamp(0, num_classes),
                   num_classes + 1).float()
    return torch.where(valid[..., None], oh, torch.zeros_like(oh))


def synthetic_probs(classes: torch.Tensor, scores: torch.Tensor,
                    num_classes: int, valid: torch.Tensor) -> torch.Tensor:
    """p[cls] = score, the remaining 1 − score spread over the other
    foreground classes; the background column stays 0."""
    oh = F.one_hot(classes.long().clamp(0, num_classes),
                   num_classes + 1).float()
    rest = (1.0 - scores[..., None]) / max(num_classes - 1, 1)
    probs = oh * scores[..., None] + (1.0 - oh) * rest
    probs[..., -1] = 0.0
    return torch.where(valid[..., None], probs, torch.zeros_like(probs))


class ClassOnlyAdapter:
    """Wrap a detector: its probs become one-hot labels, its scores 1."""

    def __init__(self, detector: Callable, num_classes: int):
        self.detector = detector
        self.num_classes = num_classes

    def __call__(self, images_u8, image_hw) -> Detections:
        det = self.detector(images_u8, image_hw)
        probs = one_hot_probs(det.classes, self.num_classes, det.valid)
        return det.replace(probs=probs, scores=det.valid.float())


class SyntheticProbAdapter:
    def __init__(self, detector: Callable, num_classes: int):
        self.detector = detector
        self.num_classes = num_classes

    def __call__(self, images_u8, image_hw) -> Detections:
        det = self.detector(images_u8, image_hw)
        return det.replace(probs=synthetic_probs(
            det.classes, det.scores, self.num_classes, det.valid))


class GDINO15APIDetector:
    """The remote Grounding DINO 1.5 API teacher: it posts every image to
    an HTTPS endpoint, which the port does not do (ROADMAP item 20)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "GDINO1_5_API: the Grounding DINO 1.5 API teacher needs the "
            "network and is not ported (ROADMAP item 20)")
