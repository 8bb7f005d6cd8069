"""Training and evaluation from the command line (counterpart of the
repo's train_net.py, with its flags and its dispatch on CLOUD.Trainer).

    python -m coin_tpu_torch.tools.train_net --config CFG [--eval-only]
        [--resume] [--test_model_role student|teacher] [--data-root DIR]
        [--device cuda|cpu] [KEY VALUE ...]

Stage 2 of a recipe, the pre-train on stage 1b's ``CLIP_collect.npz``:
``--config configs/coin/PRETRAINS/CLIPDET_foggy.yaml``, which writes
``$OUTPUT_DIR/checkpoints/pre_train_CLIP_<MAX_ITER>``. Stage 3 from it:
``--config configs/coin/GDINO/foggy_fast.yaml MODEL.WEIGHTS
<that checkpoint>``. The oracle, the supervised upper bound:
``--config configs/coin/ORACLE/foggy.yaml``. ``--eval-only`` evaluates
(the latest checkpoint with ``--resume``); the GDINO_test, GLIP_test and
CLIP_test trainers only
evaluate. ``DATASETS.CUSTOM`` registers VOC-layout datasets. The launcher
flags of the reference CLI (``--num-gpus`` and the like) are accepted and
ignored. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="coin_tpu_torch train/eval")
    p.add_argument("--config", "--config-file", dest="config", default="")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--test_model_role", default="student",
                   choices=["student", "teacher"])
    p.add_argument("--data-root", default=None,
                   help="override DATASETS.ROOT")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    # the reference CLI's launcher flags: accepted and ignored
    p.add_argument("--num-gpus", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--num-machines", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--machine-rank", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--dist-url", default=None, help=argparse.SUPPRESS)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="KEY VALUE config overrides")
    return p.parse_args(argv)


def setup(args):
    """The config of ``args`` (YAML, overrides, ``--data-root``), its
    datasets registered, OUTPUT_DIR with its log, seeds and snapshot."""
    from coin_tpu_torch.config import load_config
    from coin_tpu_torch.data.voc import register_pascal_voc
    from coin_tpu_torch.utils.setup import default_setup
    cfg = load_config(args.config or None, args.opts)
    if args.data_root:
        cfg.DATASETS.ROOT = args.data_root
    for spec in cfg.DATASETS.get("CUSTOM", []):
        register_pascal_voc(spec["NAME"], spec["DIRNAME"], spec["SPLIT"],
                            spec["CLASSES"], spec.get("EXT", ".jpg"))
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s %(name)s] %(message)s",
        handlers=[logging.StreamHandler(sys.stdout),
                  logging.FileHandler(os.path.join(cfg.OUTPUT_DIR,
                                                   "log.txt"))])
    logging.getLogger(__name__).info("config: %s  trainer: %s",
                                     args.config, cfg.CLOUD.Trainer)
    default_setup(cfg)
    return cfg


def build_trainer(cfg, device="cuda"):
    """The trainer ``CLOUD.Trainer`` names, on ``device``."""
    name = cfg.CLOUD.Trainer
    if name == "OracleTrainer":
        from coin_tpu_torch.engine.oracle import OracleTrainer
        return OracleTrainer(cfg, device=device)
    if name == "PRETrainer":
        from coin_tpu_torch.engine.pre_train import PRETrainer
        return PRETrainer(cfg, device=device)
    if name == "CoinTrainer":
        from coin_tpu_torch.engine.trainer import CoinTrainer
        return CoinTrainer(cfg, device=device)
    if name == "ModelZoo_test":
        # evaluate a released target-detector checkpoint
        from coin_tpu_torch.data.voc import get_dataset
        from coin_tpu_torch.engine.results_store import ResultStore
        from coin_tpu_torch.engine.trainer import CoinTrainer
        spec = get_dataset(cfg.DATASETS.TEST[0])
        return CoinTrainer(cfg, store=ResultStore(len(spec.class_names)),
                           device=device)
    if name in ("GDINO_test", "GLIP_test", "CLIP_test"):
        from coin_tpu_torch.engine.test import build_eval_trainer
        return build_eval_trainer(cfg, name, device)
    raise ValueError(f"unknown CLOUD.Trainer: {name}")


def main(argv=None):
    """Evaluation returns the results; training returns the trainer."""
    from coin_tpu_torch.device import resolve_device
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = setup(args)
    trainer = build_trainer(cfg, device)
    # the test trainers only evaluate
    if not hasattr(trainer, "train"):
        args.eval_only = True
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        if (args.test_model_role == "teacher"
                and hasattr(trainer, "test_teacher")):
            results = trainer.test_teacher()
        else:
            results = trainer.test()
        from coin_tpu_torch.evaluation import (print_csv_format,
                                               verify_results)
        print(print_csv_format(results))
        verify_results(cfg.TEST.EXPECTED_RESULTS, results)
        return results
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
