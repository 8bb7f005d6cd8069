"""Training and evaluation from the command line (counterpart of the
repo's train_net.py, with its flags and its dispatch on CLOUD.Trainer).

    python -m coin_tpu_torch.tools.train_net --config CFG [--eval-only]
        [--resume] [--test_model_role student|teacher] [--data-root DIR]
        [--device cuda|cpu] [--num-gpus N] [--num-machines M]
        [--machine-rank R] [--dist-url tcp://HOST:PORT] [KEY VALUE ...]

Stage 2 of a recipe, the pre-train on stage 1b's ``CLIP_collect.npz``:
``--config configs/coin/PRETRAINS/CLIPDET_foggy.yaml``, which writes
``$OUTPUT_DIR/checkpoints/pre_train_CLIP_<MAX_ITER>``. Stage 3 from it:
``--config configs/coin/GDINO/foggy_fast.yaml MODEL.WEIGHTS
<that checkpoint>``. The oracle, the supervised upper bound:
``--config configs/coin/ORACLE/foggy.yaml``. ``--eval-only`` evaluates
(the latest checkpoint with ``--resume``); the GDINO_test, GLIP_test and
CLIP_test trainers only
evaluate. ``DATASETS.CUSTOM`` registers VOC-layout datasets. Runs on the
card unless ``--device cpu``.

Data parallel, as detectron2's ``launch``: ``--num-gpus N`` starts N
processes on this machine, one per card, in a process group of N x
``--num-machines`` ranks (NCCL; gloo with ``--device cpu``), this machine
holding ranks ``--machine-rank`` x N onwards, meeting at ``--dist-url``
(a free local port on one machine). ``torchrun --nproc_per_node N -m
coin_tpu_torch.tools.train_net ...`` works too. The global batch
(SOLVER.IMG_PER_BATCH_UNLABEL, scaled first by SOLVER.REFERENCE_WORLD_SIZE
when that is set) must be a multiple of the ranks; the shipped batch of 3
runs on 1 or 3 cards. Only rank 0 writes the log file, the snapshot,
checkpoints and metrics.
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
    p.add_argument("--num-gpus", type=int, default=1,
                   help="processes on this machine, one per card")
    p.add_argument("--num-machines", type=int, default=1)
    p.add_argument("--machine-rank", type=int, default=0,
                   help="this machine's index among --num-machines")
    p.add_argument("--dist-url", default="auto",
                   help="the process group's rendezvous, tcp://HOST:PORT "
                        "(auto: a free local port, one machine)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="KEY VALUE config overrides")
    return p.parse_args(argv)


def setup(args):
    """The config of ``args`` (YAML, overrides, ``--data-root``), its
    datasets registered, OUTPUT_DIR with its log, seeds and snapshot (the
    log file and the snapshot on rank 0 only)."""
    from coin_tpu_torch.config import load_config
    from coin_tpu_torch.data.voc import register_pascal_voc
    from coin_tpu_torch.parallel.multihost import is_main_process
    from coin_tpu_torch.utils.setup import default_setup, seed_all
    cfg = load_config(args.config or None, args.opts)
    if args.data_root:
        cfg.DATASETS.ROOT = args.data_root
    for spec in cfg.DATASETS.get("CUSTOM", []):
        register_pascal_voc(spec["NAME"], spec["DIRNAME"], spec["SPLIT"],
                            spec["CLASSES"], spec.get("EXT", ".jpg"))
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    main_rank = is_main_process()
    handlers = [logging.StreamHandler(sys.stdout)]
    if main_rank:
        handlers.append(logging.FileHandler(os.path.join(cfg.OUTPUT_DIR,
                                                         "log.txt")))
    logging.basicConfig(
        level=logging.INFO if main_rank else logging.WARNING,
        format="[%(asctime)s %(name)s] %(message)s", handlers=handlers)
    logging.getLogger(__name__).info("config: %s  trainer: %s",
                                     args.config, cfg.CLOUD.Trainer)
    if main_rank:
        default_setup(cfg)
    else:
        seed_all(cfg.SEED)
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
    """Evaluation returns the results; training returns the trainer (of
    this process; None when it launched ranks of its own)."""
    from coin_tpu_torch.parallel import mesh_utils
    args = parse_args(argv)
    if args.num_gpus * args.num_machines > 1:
        mesh_utils.launch(run, args.num_gpus, args.num_machines,
                          args.machine_rank, args.dist_url, args=(args,),
                          device=args.device)
        return None
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:   # under torchrun
        mesh_utils.init_distributed(device=args.device)
    return run(args)


def run(args):
    """One rank's run of the parsed ``args`` (the whole run without a
    process group)."""
    from coin_tpu_torch.device import resolve_device
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
