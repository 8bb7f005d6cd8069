"""Checkpoints of the port's TrainState (counterpart of
coin_tpu/engine/checkpoint.py, with its names and paths:
``<OUTPUT_DIR>/checkpoints/model_%07d``, ``<path>.extras.json``,
``latest_path``, ``load_tree``).

A checkpoint is one ``torch.save`` file holding everything a resumed run
needs to continue bit for bit: the student, teacher and CKG state dicts,
both optimizers (update count and momentum), the prototypes, the step and
the state of the step's random generator. A pre-train state has no
teacher, CKG net or merge optimizer, and its checkpoint no such entries;
``CoinTrainer`` starts from one through ``MODEL.WEIGHTS``. An oracle
state has no prototypes either. Orbax
checkpoints of the JAX package are not read here: the repo's
``tools/jax_ckpt_to_torch.py`` converts one into this file. In a process
group only rank 0 writes (``write=False`` elsewhere); every rank reads.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, Optional

import torch

logger = logging.getLogger(__name__)


def _cpu(sd):
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def _optimizer_tree(opt) -> dict:
    return {"count": int(opt.count),
            "momentum": {n: b.detach().cpu().clone() for n, b in
                         opt.momentum_buffers().items() if b is not None}}


def state_tree(state) -> dict:
    """The port's TrainState as a tree of CPU tensors and numbers (without
    the entries of the fields that a pre-train or oracle state leaves
    None)."""
    tree = {"model": _cpu(state.model.state_dict()),
            "optimizer": _optimizer_tree(state.optimizer),
            "step": int(state.step),
            "generator": state.generator.get_state()}
    p = state.prototypes
    if p is not None:
        tree["prototypes"] = {
            "proto": p.proto.detach().cpu().clone(),
            "b_online": p.b_online.detach().cpu().clone(),
            "b_offline": p.b_offline.detach().cpu().clone()}
    if state.teacher is not None:
        tree.update(teacher=_cpu(state.teacher.state_dict()),
                    merge_model=_cpu(state.merge_model.state_dict()),
                    merge_optimizer=_optimizer_tree(state.merge_optimizer))
    return tree


@torch.no_grad()
def load_state_tree(state, tree: dict):
    """Load ``tree`` (from :func:`state_tree`) into ``state`` in place:
    parameters are copied into the existing tensors, so modules that share
    them (an int8 clone) see the restored values. A pre-train tree loads
    into a pre-train state, an adaptation tree into an adaptation state,
    an oracle tree into an oracle state."""
    if ("teacher" in tree) != (state.teacher is not None):
        raise ValueError("a pre-train checkpoint restores only a pre-train "
                         "state (start CoinTrainer from one through "
                         "MODEL.WEIGHTS)")
    if ("prototypes" in tree) != (state.prototypes is not None):
        raise ValueError("an oracle checkpoint restores only an oracle "
                         "state")
    state.model.load_state_dict(tree["model"])
    opts = [(state.optimizer, tree["optimizer"])]
    if state.teacher is not None:
        state.teacher.load_state_dict(tree["teacher"])
        state.merge_model.load_state_dict(tree["merge_model"])
        opts.append((state.merge_optimizer, tree["merge_optimizer"]))
    for opt, t in opts:
        opt.count = int(t["count"])
        opt.set_momentum_buffers(t["momentum"])
    if state.prototypes is not None:
        dev = state.prototypes.proto.device
        pr = tree["prototypes"]
        state.prototypes = type(state.prototypes)(
            *(pr[k].to(dev) for k in ("proto", "b_online", "b_offline")))
    state.step = int(tree["step"])
    state.generator.set_state(tree["generator"])
    return state


class Checkpointer:
    def __init__(self, output_dir: str, prefix: str = "model",
                 write: bool = True):
        self.dir = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        os.makedirs(self.dir, exist_ok=True)
        self.prefix = prefix
        self.write = write

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"{self.prefix}_{step:07d}")

    def save(self, state: Any, step: int, name: Optional[str] = None,
             extras: Optional[dict] = None) -> str:
        path = os.path.join(self.dir, name) if name else self._path(step)
        if not self.write:
            return path
        torch.save(state_tree(state), path)
        if extras:
            with open(path + ".extras.json", "w") as f:
                json.dump(extras, f)
        logger.info("saved checkpoint: %s", path)
        return path

    def load_extras(self, path: str) -> dict:
        p = path + ".extras.json"
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def latest_path(self) -> Optional[str]:
        if not os.path.isdir(self.dir):
            return None
        best, best_step = None, -1
        for d in os.listdir(self.dir):
            m = re.match(rf"{self.prefix}_(\d+)$", d)
            if m and int(m.group(1)) > best_step:
                best, best_step = os.path.join(self.dir, d), int(m.group(1))
        return best

    def load(self, path: str, state: Any) -> Any:
        load_state_tree(state, self.load_tree(path))
        logger.info("restored checkpoint: %s", path)
        return state

    def load_tree(self, path: str) -> dict:
        """The raw tree of a checkpoint, whatever trainer saved it."""
        return torch.load(path, map_location="cpu", weights_only=True)

    def load_latest(self, state: Any) -> Any:
        path = self.latest_path()
        if path is None:
            logger.info("no checkpoint found in %s", self.dir)
            return state
        return self.load(path, state)
