"""Box visualization (counterpart of coin_tpu/utils/visualize.py: the
draw_result/draw_gt debug fixtures of the reference,
gdino_processor.py:304-340 / clip_rcnn.py:165-184), using PIL instead of
cv2/supervision."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

_PALETTE = [(230, 80, 60), (60, 160, 230), (90, 200, 90), (240, 180, 50),
            (170, 100, 220), (80, 210, 200), (240, 120, 180),
            (150, 150, 150)]


def draw_detections(image: np.ndarray, boxes: np.ndarray,
                    scores: Optional[np.ndarray] = None,
                    classes: Optional[np.ndarray] = None,
                    class_names: Optional[Sequence[str]] = None,
                    save_path: Optional[str] = None) -> Image.Image:
    """image (H, W, 3) uint8; boxes (N, 4) xyxy (numpy arrays, or tensors
    on any device). Returns (and optionally saves) the annotated PIL
    image."""
    image, boxes, scores, classes = (
        None if a is None else _host(a)
        for a in (image, boxes, scores, classes))
    img = Image.fromarray(np.asarray(image, np.uint8)).convert("RGB")
    drawer = ImageDraw.Draw(img)
    for i, box in enumerate(np.asarray(boxes)):
        cls = int(classes[i]) if classes is not None else 0
        color = _PALETTE[cls % len(_PALETTE)]
        drawer.rectangle([float(box[0]), float(box[1]),
                          float(box[2]), float(box[3])],
                         outline=color, width=2)
        label = ""
        if class_names is not None and classes is not None:
            label = class_names[cls]
        elif classes is not None:
            label = str(cls)
        if scores is not None:
            label = f"{label} {float(scores[i]):.2f}".strip()
        if label:
            drawer.text((float(box[0]) + 2, float(box[1]) + 2), label,
                        fill=color)
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)),
                    exist_ok=True)
        img.save(save_path)
    return img


def _host(a):
    """A numpy array of ``a`` (a tensor is read back from its device)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)
