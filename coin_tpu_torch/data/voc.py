"""Copy of coin_tpu/data/voc.py (host-only; without the training fixture
``make_synthetic_voc_rich``), kept so the port imports nothing of coin_tpu.

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
