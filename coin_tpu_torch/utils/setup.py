"""Run setup: seeding, the environment, a snapshot of the config and the
code (counterpart of coin_tpu/utils/setup.py; JAX's persistent compile
cache has no counterpart)."""

from __future__ import annotations

import logging
import os
import random
import shutil
import sys

import numpy as np
import torch

logger = logging.getLogger(__name__)


def seed_all(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (and every
    card's) with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def dump_environment() -> str:
    lines = [f"python: {sys.version.split()[0]}",
             f"torch: {torch.__version__}, CUDA {torch.version.cuda}"]
    if torch.cuda.is_available():
        lines.append("devices: " + ", ".join(
            torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count())))
    else:
        lines.append("devices: none (CPU only)")
    return "\n".join(lines)


def snapshot_run(cfg, output_dir: str) -> None:
    """Reproducibility artifacts in ``output_dir``: the merged config
    (config.yaml) and a copy of the coin_tpu_torch package
    (code_snapshot/, its built kernels left out)."""
    import yaml
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(_plain(cfg), f, sort_keys=False)
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(output_dir, "code_snapshot")
    if not os.path.exists(dst):
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
            "__pycache__", "*.pyc", "*.so", "_build", "output"))
    logger.info("run snapshot written to %s", output_dir)


def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


def default_setup(cfg) -> None:
    seed_all(cfg.SEED)
    logger.info("environment:\n%s", dump_environment())
    snapshot_run(cfg, cfg.OUTPUT_DIR)
