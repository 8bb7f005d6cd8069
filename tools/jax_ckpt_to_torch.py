#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package into one of the PyTorch port
(ROADMAP item 21b), so that a run trained in JAX continues on the card.

    python tools/jax_ckpt_to_torch.py --config CFG --jax-ckpt DIR
        [--output-dir DIR] [KEY VALUE ...]

DIR is a checkpoint that ``coin_tpu/engine/checkpoint.Checkpointer`` wrote
(an orbax ``PyTreeCheckpointer`` directory such as
``<OUTPUT_DIR>/checkpoints/model_0001000`` or ``pre_train_CLIP_0050000``):
an adaptation state (``CoinTrainer``), a pre-train state (``PRETrainer``:
no teacher, no CKG net) or an oracle state (``OracleTrainer``: no
prototypes either); the script tells them apart by the fields the tree
holds. CFG is the run's config (``configs/coin/...yaml`` with the same
overrides): it gives the detector's shape and ``SEED``. The port's
``engine.checkpoint.Checkpointer`` file is written under the same name
into ``<output-dir>/checkpoints/`` (``OUTPUT_DIR`` of the config by
default), with the JAX checkpoint's ``.extras.json`` beside it when there
is one. Then

    python -m coin_tpu_torch.tools.train_net --config CFG --resume

continues the run on the card from it (a pre-train checkpoint starts
stage 3 through ``MODEL.WEIGHTS`` instead).

Every field carries over through ``coin_tpu_torch.convert_from_jax.
load_train_state``: the student and its frozen leaves, the optimizers'
momentum and update counts, the teacher and the CKG net, the prototypes
and the step. One does not: JAX's PRNG key has no counterpart in a
``torch.Generator``'s state, so the port's step generator is seeded
``SEED + 1 + step`` (the port seeds it ``SEED + 1`` at step 0). The
random draws of the continued run are therefore the port's own, not the
ones the JAX run would have drawn.

This script imports both packages (JAX runs on the CPU); the port itself
stays free of JAX.
"""

from __future__ import annotations

import argparse
import collections
import os
import shutil
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chain(opt_state):
    """An optax chain's state as orbax restores it without a target (a
    list of dicts, None for empty states) → tuples with the NamedTuple
    fields that ``load_train_state`` reads (``trace``, ``count``)."""
    if opt_state is None:
        return None
    out = []
    for s in opt_state:
        if isinstance(s, dict):
            s = collections.namedtuple("OptState", list(s))(**s)
        out.append(s)
    return tuple(out)


def jax_state_tree(path: str) -> types.SimpleNamespace:
    """The JAX TrainState of checkpoint ``path`` as numpy trees, in the
    fields ``load_train_state`` reads."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from coin_tpu.engine.checkpoint import Checkpointer as JCheckpointer
    raw = JCheckpointer(os.path.dirname(os.path.dirname(
        os.path.abspath(path)))).load_tree(path)
    protos = raw.get("prototypes")
    return types.SimpleNamespace(
        params=raw["params"], frozen=raw.get("frozen") or {},
        opt_state=_chain(raw["opt_state"]), step=raw["step"],
        prototypes=None if protos is None
        else types.SimpleNamespace(**protos),
        teacher_params=raw.get("teacher_params"),
        merge_params=raw.get("merge_params"),
        merge_opt_state=_chain(raw.get("merge_opt_state")))


def port_state_for(cfg, jtree, num_classes: int):
    """A port TrainState on the CPU of the kind ``jtree`` holds, built for
    ``cfg``'s detector: the adaptation step's, the pre-train step's or the
    oracle's."""
    import torch
    from coin_tpu_torch.engine import pipelines
    from coin_tpu_torch.engine.oracle import init_oracle_state
    from coin_tpu_torch.engine.pre_train import init_pretrain_state
    from coin_tpu_torch.engine.step_builder import init_train_state
    model = pipelines.build_detector(cfg, num_classes, "cpu")
    proto0 = torch.zeros((num_classes + 1, model.text_dim))
    if jtree.teacher_params is not None:
        tokens = torch.zeros((num_classes + 1, 77), dtype=torch.long)
        return init_train_state(cfg, model, tokens, cfg.SEED, proto0=proto0)
    if jtree.prototypes is not None:
        return init_pretrain_state(cfg, model, cfg.SEED, proto0)
    return init_oracle_state(cfg, model, cfg.SEED)


def convert(cfg, jax_ckpt: str, output_dir: str,
            num_classes: int = None) -> str:
    """Write the port's checkpoint of the JAX checkpoint ``jax_ckpt``
    under its name into ``output_dir/checkpoints``; returns its path.
    ``num_classes`` defaults to those of ``DATASETS.TRAIN_UNLABEL[0]``."""
    from coin_tpu_torch.convert_from_jax import load_train_state
    from coin_tpu_torch.engine.checkpoint import Checkpointer
    if num_classes is None:
        from coin_tpu_torch.data.voc import get_dataset
        num_classes = len(get_dataset(
            cfg.DATASETS.TRAIN_UNLABEL[0]).class_names)
    jtree = jax_state_tree(jax_ckpt)
    state = port_state_for(cfg, jtree, num_classes)
    load_train_state(state, jtree)
    state.generator.manual_seed(cfg.SEED + 1 + int(state.step))
    jax_ckpt = os.path.abspath(jax_ckpt)
    name = os.path.basename(jax_ckpt.rstrip("/"))
    path = Checkpointer(output_dir).save(state, int(state.step), name=name)
    if os.path.exists(jax_ckpt + ".extras.json"):
        shutil.copyfile(jax_ckpt + ".extras.json", path + ".extras.json")
    return path


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--jax-ckpt", required=True,
                   help="a checkpoint directory of coin_tpu's Checkpointer")
    p.add_argument("--output-dir", default=None,
                   help="the port run's OUTPUT_DIR (the config's by "
                        "default)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="KEY VALUE config overrides")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    from coin_tpu_torch.config import load_config
    from coin_tpu_torch.data.voc import register_pascal_voc
    cfg = load_config(args.config, args.opts)
    for spec in cfg.DATASETS.get("CUSTOM", []):
        register_pascal_voc(spec["NAME"], spec["DIRNAME"], spec["SPLIT"],
                            spec["CLASSES"], spec.get("EXT", ".jpg"))
    path = convert(cfg, args.jax_ckpt, args.output_dir or cfg.OUTPUT_DIR)
    print(f"wrote the port's checkpoint: {path}")
    return path


if __name__ == "__main__":
    main()
