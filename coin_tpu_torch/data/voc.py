"""Copy of coin_tpu/data/voc.py (host-only), kept so the port imports
nothing of coin_tpu.

VOC-format dataset indexing + the COIN dataset registry.

Mirrors coin/data/datasets/pascal_voc.py (XML → dicts, 1-based → 0-based
boxes, unknown classes skipped) and builtin.py:121-175 (16 splits across
Cityscapes / Foggy / BDD100K / Clipart / KITTI / SIM10K, rooted at
$DETECTRON2_DATASETS).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

CITYSCAPES_CLASSES = ("truck", "car", "rider", "person", "train",
                      "motorcycle", "bicycle", "bus")
BDD_CLASSES = ("person", "rider", "car", "truck", "bus", "motorcycle",
               "bicycle")
SIM_CLASSES = ("car", "motorbike", "person")
CLIPART_CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
                   "car", "cat", "chair", "cow", "diningtable", "dog",
                   "horse", "motorbike", "person", "pottedplant", "sheep",
                   "sofa", "train", "tvmonitor")
CAR_CLASSES = ("car",)


@dataclass
class DatasetSpec:
    name: str
    dirname: str                 # relative to DATASETS.ROOT
    split: str                   # e.g. train / val
    class_names: Sequence[str]
    image_ext: str = ".png"


DATASET_REGISTRY: Dict[str, DatasetSpec] = {}


def register_pascal_voc(name: str, dirname: str, split: str,
                        class_names: Sequence[str],
                        image_ext: str = ".png") -> None:
    DATASET_REGISTRY[name] = DatasetSpec(name, dirname, split,
                                         tuple(class_names), image_ext)


def register_all_builtin() -> None:
    """The 16 reference splits, with the reference's exact names,
    directory layout (<root>/<dirname>/{Annotations,ImageSets/Main/
    <split>.txt,JPEGImages}), image formats, and class ORDERS — class
    index order defines the label ids in collect stores and per-class AP
    rows (coin/data/datasets/builtin.py:121-175)."""
    specs = [
        # Cityscapes / Foggy-Cityscapes (shared VOC tree)
        ("citytrain", "CityScapes_FoggyCityScapes", "train_city",
         CITYSCAPES_CLASSES, ".png"),
        ("cityval", "CityScapes_FoggyCityScapes", "val_city",
         CITYSCAPES_CLASSES, ".png"),
        ("foggytrain", "CityScapes_FoggyCityScapes", "train_foggy",
         CITYSCAPES_CLASSES, ".png"),
        ("foggyval", "CityScapes_FoggyCityScapes", "val_foggy",
         CITYSCAPES_CLASSES, ".png"),
        ("foggytrain_0.02", "CityScapes_FoggyCityScapes",
         "train_foggy_0.02", CITYSCAPES_CLASSES, ".png"),
        ("foggyval_0.02", "CityScapes_FoggyCityScapes",
         "val_foggy_0.02", CITYSCAPES_CLASSES, ".png"),
        ("citytrain_car", "CityScapes_FoggyCityScapes", "train_city_car",
         CAR_CLASSES, ".png"),
        ("cityval_car", "CityScapes_FoggyCityScapes", "val_city_car",
         CAR_CLASSES, ".png"),
        # Clipart (single "all" split used for both train and test)
        ("cliparttrain", "clipart", "all", CLIPART_CLASSES, ".jpg"),
        ("clipartval", "clipart", "all", CLIPART_CLASSES, ".jpg"),
        # KITTI / SIM10K (car-only adaptation; trainval doubles as test)
        ("KITTItrainval", "KITTI", "train_car", CAR_CLASSES, ".png"),
        ("SIMtrainval_car", "SIM", "train_car", CAR_CLASSES, ".jpg"),
        ("SIMtrainval", "SIM", "train", SIM_CLASSES, ".jpg"),
        # BDD100K
        ("BDD100Ktrain", "BDD100K_voc", "train_object", BDD_CLASSES,
         ".jpg"),
        ("BDD100Kval", "BDD100K_voc", "val_object", BDD_CLASSES, ".jpg"),
    ]
    for name, dirname, split, classes, ext in specs:
        register_pascal_voc(name, dirname, split, classes, ext)
    # legacy coin_tpu aliases (round-1 configs) → reference specs
    for alias, ref in [("bddtrain", "BDD100Ktrain"),
                       ("bddval", "BDD100Kval"),
                       ("kittitrain", "KITTItrainval"),
                       ("kittival", "KITTItrainval"),
                       ("simtrain", "SIMtrainval_car"),
                       ("simval", "SIMtrainval_car")]:
        DATASET_REGISTRY[alias] = DATASET_REGISTRY[ref]


def get_dataset(name: str) -> DatasetSpec:
    if name not in DATASET_REGISTRY:
        register_all_builtin()
    if name not in DATASET_REGISTRY:
        raise KeyError(
            f"unknown dataset '{name}'; registered: "
            f"{sorted(DATASET_REGISTRY)} (register custom VOC datasets via "
            f"DATASETS.CUSTOM or coin_tpu_torch.data.voc.register_pascal_voc)")
    return DATASET_REGISTRY[name]


def load_voc_instances(dirname: str, split: str,
                       class_names: Sequence[str],
                       image_ext: str = ".jpg") -> List[dict]:
    """Parse a VOC split into detectron2-style dicts
    (coin/data/datasets/pascal_voc.py:25-83)."""
    with open(os.path.join(dirname, "ImageSets", "Main",
                           split + ".txt")) as f:
        fileids = [line.strip() for line in f if line.strip()]
    name_to_id = {n: i for i, n in enumerate(class_names)}
    out = []
    for fileid in fileids:
        anno_file = os.path.join(dirname, "Annotations", fileid + ".xml")
        image_file = os.path.join(dirname, "JPEGImages", fileid + image_ext)
        rec = {"file_name": image_file, "image_id": fileid}
        boxes, classes, difficult = [], [], []
        if os.path.exists(anno_file):
            tree = ET.parse(anno_file)
            size = tree.find("size")
            if size is not None:
                rec["width"] = int(float(size.find("width").text))
                rec["height"] = int(float(size.find("height").text))
            for obj in tree.findall("object"):
                cls = obj.find("name").text
                if cls not in name_to_id:
                    continue  # unknown classes skipped
                bb = obj.find("bndbox")
                box = [float(bb.find(t).text)
                       for t in ("xmin", "ymin", "xmax", "ymax")]
                # 1-based inclusive → 0-based (pascal_voc.py convention)
                box[0] -= 1.0
                box[1] -= 1.0
                boxes.append(box)
                classes.append(name_to_id[cls])
                diff = obj.find("difficult")
                difficult.append(int(diff.text) if diff is not None else 0)
        rec["boxes"] = np.asarray(boxes, np.float32).reshape(-1, 4)
        rec["classes"] = np.asarray(classes, np.int64)
        rec["difficult"] = np.asarray(difficult, bool)
        out.append(rec)
    return out


def make_synthetic_voc_rich(root: str, num_images: int = 512,
                            class_names: Sequence[str] = ("car", "person"),
                            image_hw=(120, 160), seed: int = 0,
                            split: str = "train") -> str:
    """Fixture-v3 synthetic VOC generator (round-4 A/B harness).

    The round-3 verdicts showed the 64-image flat fixture has a
    ±6.5–16 AP50 noise floor — every knob A/B came back INCONCLUSIVE.
    v3 targets a ≤±2 AP50 A/A floor by making the data richer and the
    task statistically denser while staying CPU-cheap:

      - multi-scale objects: box scale log-uniform in [12, 56] px on a
        120×160 canvas (≈[10, 45] px after the 0.8 train resize), so
        proposal-budget / sampling knobs act on a real scale spectrum;
      - 2–7 instances per image with overlap rejection (IoU ≤ 0.4);
      - class-distinctive but jittered appearance (color jitter ±28,
        per-image brightness, internal structure) — separable, not
        solved-at-init;
      - background clutter: smooth low-frequency blobs plus 1–3
        distractor shapes in non-class colors;
      - enough images (512 train / 256 eval) that per-box granularity
        of AP50 is ≪ 1 AP and no pretrain seed flatlines.
    """
    from PIL import Image
    rng = np.random.RandomState(seed)
    h, w = image_hw
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    # class base colors (BGR-distinct, jittered per instance)
    base_colors = {class_names[0]: np.array([60, 120, 210], np.float32),
                   class_names[1] if len(class_names) > 1 else "_":
                       np.array([210, 70, 60], np.float32)}
    distractor_colors = [np.array(c, np.float32) for c in
                         ([120, 120, 120], [80, 170, 80], [190, 180, 70])]

    def _iou(a, b):
        ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
        iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = ix * iy
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    ids = []
    for i in range(num_images):
        fid = f"{split}_{i:04d}"
        ids.append(fid)
        # background: smooth gradient + low-frequency blobs + mild noise
        base = rng.uniform(40, 160, 3).astype(np.float32)
        yy = np.linspace(-1, 1, h)[:, None, None]
        xx = np.linspace(-1, 1, w)[None, :, None]
        img = (base + 25 * yy * rng.uniform(-1, 1)
               + 25 * xx * rng.uniform(-1, 1))
        img = np.broadcast_to(img, (h, w, 3)).astype(np.float32).copy()
        for _ in range(rng.randint(2, 5)):  # low-freq blobs
            cy, cx = rng.randint(0, h), rng.randint(0, w)
            r = rng.randint(15, 50)
            dy = (np.arange(h)[:, None] - cy) / r
            dx = (np.arange(w)[None, :] - cx) / r
            mask = np.exp(-(dy ** 2 + dx ** 2))
            img += mask[:, :, None] * rng.uniform(-30, 30, 3)
        img += rng.normal(0, 6, (h, w, 3))

        def place(min_s=12, max_s=56, avoid=None, tries=12):
            for _ in range(tries):
                s = float(np.exp(rng.uniform(np.log(min_s),
                                             np.log(max_s))))
                ar = float(np.exp(rng.uniform(np.log(0.6), np.log(1.7))))
                bw = int(round(s * ar))
                bh = int(round(s / ar))
                bw, bh = max(bw, 8), max(bh, 8)
                if bw >= w - 2 or bh >= h - 2:
                    continue
                x1 = rng.randint(1, w - bw - 1)
                y1 = rng.randint(1, h - bh - 1)
                box = (x1, y1, x1 + bw, y1 + bh)
                if avoid is None or all(_iou(box, b) <= 0.4
                                        for b in avoid):
                    return box
            return None

        placed, objs = [], []
        for _ in range(rng.randint(2, 8)):
            box = place(avoid=placed)
            if box is None:
                continue
            x1, y1, x2, y2 = box
            cls = class_names[rng.randint(len(class_names))]
            color = (base_colors.get(cls, distractor_colors[0])
                     + rng.uniform(-28, 28, 3))
            img[y1:y2, x1:x2] = color
            # class-distinctive internal structure (jittered)
            if cls == class_names[0]:   # "car": darker roof stripe
                t = max((y2 - y1) // 3, 2)
                img[y1:y1 + t, x1:x2] = color * 0.55
            else:                       # "person": darker head band
                t = max((y2 - y1) // 4, 2)
                cxm = (x1 + x2) // 2
                half = max((x2 - x1) // 4, 2)
                img[y1:y1 + t, cxm - half:cxm + half] = color * 0.5
            placed.append(box)
            objs.append((cls, x1 + 1, y1 + 1, x2 + 1, y2 + 1))
        for _ in range(rng.randint(1, 4)):  # distractor clutter
            box = place(min_s=8, max_s=36, avoid=placed)
            if box is None:
                continue
            x1, y1, x2, y2 = box
            color = (distractor_colors[rng.randint(3)]
                     + rng.uniform(-20, 20, 3))
            img[y1:y2, x1:x2] = color
            placed.append(box)

        # per-image brightness jitter, clamp, save
        img = np.clip(img * rng.uniform(0.85, 1.15), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(root, "JPEGImages", fid + ".jpg"))
        obj_xml = "".join(
            f"<object><name>{c}</name><difficult>0</difficult>"
            f"<bndbox><xmin>{a}</xmin><ymin>{b}</ymin>"
            f"<xmax>{cx}</xmax><ymax>{d}</ymax></bndbox></object>"
            for c, a, b, cx, d in objs)
        with open(os.path.join(root, "Annotations", fid + ".xml"),
                  "w") as f:
            f.write(f"<annotation><size><width>{w}</width>"
                    f"<height>{h}</height></size>{obj_xml}</annotation>")
    with open(os.path.join(root, "ImageSets", "Main", split + ".txt"),
              "w") as f:
        f.write("\n".join(ids) + "\n")
    return root


def make_synthetic_voc(root: str, num_images: int = 8,
                       class_names: Sequence[str] = ("car", "person"),
                       image_hw=(120, 160), seed: int = 0,
                       split: str = "train") -> str:
    """Write a tiny synthetic VOC dataset (for tests / smoke runs)."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    h, w = image_hw
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    ids = []
    for i in range(num_images):
        fid = f"{split}_{i:04d}"
        ids.append(fid)
        img = rng.randint(0, 255, (h, w, 3), np.uint8)
        objs = []
        for _ in range(rng.randint(1, 4)):
            x1 = rng.randint(0, w - 40)
            y1 = rng.randint(0, h - 40)
            bw = rng.randint(20, 40)
            bh = rng.randint(20, 40)
            cls = class_names[rng.randint(len(class_names))]
            img[y1:y1 + bh, x1:x1 + bw] = (
                np.asarray([60, 160, 220]) if cls == class_names[0]
                else np.asarray([220, 60, 60]))
            objs.append((cls, x1 + 1, y1 + 1, x1 + bw + 1, y1 + bh + 1))
        Image.fromarray(img).save(
            os.path.join(root, "JPEGImages", fid + ".jpg"))
        obj_xml = "".join(
            f"<object><name>{c}</name><difficult>0</difficult>"
            f"<bndbox><xmin>{a}</xmin><ymin>{b}</ymin>"
            f"<xmax>{cx}</xmax><ymax>{d}</ymax></bndbox></object>"
            for c, a, b, cx, d in objs)
        with open(os.path.join(root, "Annotations", fid + ".xml"),
                  "w") as f:
            f.write(f"<annotation><size><width>{w}</width>"
                    f"<height>{h}</height></size>{obj_xml}</annotation>")
    with open(os.path.join(root, "ImageSets", "Main", split + ".txt"),
              "w") as f:
        f.write("\n".join(ids) + "\n")
    return root
