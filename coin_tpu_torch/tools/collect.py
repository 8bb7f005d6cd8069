"""The collection pass from the command line (counterpart of the repo's
tools/collect.py): the cloud teacher over the unlabeled train set, the
stores written to OUTPUT_DIR.

    python -m coin_tpu_torch.tools.collect --config CFG [--skip-clip]
        [--synthetic-teacher] [--device cuda|cpu] [KEY VALUE ...]

Writes ``$OUTPUT_DIR/<arch>_collect.npz`` (the raw cloud detections, the
online teacher's cache) and, unless ``--skip-clip``,
``$OUTPUT_DIR/CLIP_collect.npz`` (the re-scored detections). It needs
MODEL.TEACHER_CLOUD.WEIGHT (a GroundingDINO or GLIP checkpoint, after
MODEL.TEACHER_CLOUD.META_ARCHITECTURE) and TPU.BERT_VOCAB (BERT's
vocab.txt); the re-scoring pass needs TPU.CLIP_WEIGHTS (OpenAI CLIP
RN50's torch archive) and TPU.CLIP_BPE_VOCAB (its BPE merges file).
``--synthetic-teacher`` needs none of them: a random-weight tiny GDINO and
a stub scorer rehearse the pipeline (the detections are meaningless).
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os

from coin_tpu_torch.config import load_config
from coin_tpu_torch.data.loader import TestLoader
from coin_tpu_torch.data.voc import get_dataset, register_pascal_voc
from coin_tpu_torch.engine import collect as collect_mod
from coin_tpu_torch.engine.cloud_factory import (build_clip_scorer,
                                                 build_cloud_detector,
                                                 build_stub_scorer,
                                                 build_synthetic_detector)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--skip-clip", action="store_true",
                   help="only the raw cloud collection")
    p.add_argument("--synthetic-teacher", action="store_true",
                   help="random-weight tiny GDINO + stub scorer: a "
                        "zero-asset rehearsal (detections are meaningless)")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = load_config(args.config, args.opts)
    for spec in cfg.DATASETS.get("CUSTOM", []):
        register_pascal_voc(spec["NAME"], spec["DIRNAME"], spec["SPLIT"],
                            spec["CLASSES"], spec.get("EXT", ".jpg"))
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    train_name = cfg.DATASETS.TRAIN_UNLABEL[0]
    class_names = get_dataset(train_name).class_names

    arch = cfg.MODEL.TEACHER_CLOUD.META_ARCHITECTURE
    tc = cfg.INPUT.TEACHER_CLOUD
    loader = TestLoader(train_name, cfg.DATASETS.ROOT, batch_size=4,
                        min_size=tc.MIN_SIZE_TEST,
                        max_size=tc.get("MAX_SIZE_TEST", 1333))
    if args.synthetic_teacher:
        detector = build_synthetic_detector(class_names, args.device)
    else:
        detector = build_cloud_detector(cfg, arch, class_names, args.device)
    ctc = cfg.CLOUD.TEACHER_CLOUD
    store = collect_mod.collect_cloud(
        detector, loader, len(class_names), nms_method=cfg.CLOUD.NMS_METHOD,
        collect_nms_thresh=ctc.COLLECT_NMS_THRESH,
        rcnn_thresh=ctc.RCNN_THRESH,
        rpn_thresh=(ctc.RPN_THRESH if ctc.RPN_SEPARATE_COLLECT
                    else ctc.RCNN_THRESH),
        collect_aug=tc.get("COLLECT_AUG", ""), device=args.device)
    out = os.path.join(cfg.OUTPUT_DIR, f"{arch}_collect.npz")
    store.save(out)
    print(f"saved cloud collection: {out}")
    if args.skip_clip:
        return

    scorer_apply = (build_stub_scorer(len(class_names))
                    if args.synthetic_teacher
                    else build_clip_scorer(cfg, class_names, args.device))
    clip_store = collect_mod.rescore_with_clip(
        scorer_apply, store, loader,
        capacity=cfg.get_path("TPU.CAP_TEACHER", 128), device=args.device)
    out2 = os.path.join(cfg.OUTPUT_DIR, "CLIP_collect.npz")
    clip_store.save(out2)
    print(f"saved re-scored collection: {out2}")


if __name__ == "__main__":
    main()
