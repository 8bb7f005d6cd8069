"""JAX parameter tree → the port's ``state_dict``.

``from_jax_variables`` takes the JAX package's variables as numpy arrays
(what ``jax.device_get(variables)`` returns; JAX itself is not imported)
and returns a ``state_dict`` for ``coin_tpu_torch``'s modules, whose names
follow the flax tree. Key ``a/b/leaf`` becomes ``a.b.<leaf>``:

- conv ``kernel`` (HWIO) → ``weight`` (OIHW);
- ``nn.Dense`` ``kernel`` (in, out) → ``Linear.weight`` (out, in);
- flax ``SelfAttention``: ``query/key/value`` kernels (in, heads, head_dim)
  and biases (heads, head_dim), the ``out`` kernel (heads, head_dim, out);
- ``LayerNorm`` ``scale`` and ``nn.Embed`` ``embedding`` → ``weight``;
- FrozenBN's four tensors and raw parameters pass through unchanged.

The same walk fills the cloud teacher: the JAX ``GroundingDINO`` tree
(``models/gdino.py`` names its modules as flax does; Swin's relative
position tables, the level and query embeddings and the fusion gammas
are raw parameters), the JAX ``GLIP`` tree (``models/glip.py`` names its
modules as flax does; DyConv's deformable kernels are HWIO convs like any
other, the head's ``bias0`` and ``log_scale`` are scalars and its level
``scales`` a vector, the fusion gammas raw parameters) and a Flax BERT
tree (``models/bert.py`` uses HF's names; ``nn.Embed``'s ``embedding`` is
a ``weight``), the JAX ``CLIPScorer`` tree (``backbone``, ``res5``,
``attnpool``: its q/k/v/c projections are Dense kernels, its positional
embedding a raw parameter) into ``models.clip_scorer.CLIPScorer``, and an
attnpool detector's tree into ``OpenVocabularyRCNN(pooling="attnpool")``.
``load_jax_params`` loads any of them strictly.

``load_train_state`` carries a whole JAX ``TrainState`` of the adaptation
step (its fields as numpy arrays) into the port's ``TrainState``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _convert(path, a: np.ndarray) -> np.ndarray:
    leaf, parent = path[-1], path[-2] if len(path) > 1 else ""
    if leaf == "kernel":
        if a.ndim == 4:
            return a.transpose(3, 2, 0, 1)
        if a.ndim == 2:
            return a.T
        if a.ndim == 3 and parent in ("query", "key", "value"):
            return a.reshape(a.shape[0], -1).T
        if a.ndim == 3 and parent == "out":
            return a.reshape(-1, a.shape[-1]).T
        raise ValueError(f"unknown kernel layout at {'/'.join(path)}: "
                         f"{a.shape}")
    if leaf == "bias" and a.ndim == 2:
        return a.reshape(-1)
    return a


def from_jax_variables(variables: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """variables: {"params": nested dict of numpy arrays} (or the params
    dict itself) → {dotted name: float32 tensor}."""
    tree = variables.get("params", variables)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for k, v in node.items():
            p = path + (k,)
            if isinstance(v, Mapping):
                walk(v, p)
                continue
            key = ".".join(p[:-1] + (_RENAME.get(k, k),))
            arr = np.ascontiguousarray(_convert(p, np.asarray(v)))
            out[key] = torch.from_numpy(arr.astype(np.float32))

    walk(tree, ())
    return out


def load_jax_params(module: torch.nn.Module, variables: Mapping[str, Any]
                    ) -> torch.nn.Module:
    """Load a JAX parameter tree (numpy leaves) into ``module`` strictly:
    the GroundingDINO tree into ``models.gdino.GroundingDINO``, the GLIP
    tree into ``models.glip.GLIP``, a Flax BERT tree into
    ``models.bert.BertModel``, the CLIP scorer's into
    ``models.clip_scorer.CLIPScorer``, or any tree whose names the module
    mirrors."""
    dev = next(module.parameters()).device
    sd = {k: v.to(dev) for k, v in from_jax_variables(variables).items()}
    module.load_state_dict(sd, strict=True)
    return module


def _merge_trees(a: Mapping, b: Mapping) -> Dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = (_merge_trees(out[k], v)
                  if k in out and isinstance(v, Mapping) else v)
    return out


def _chain_states(opt_state):
    """(trace tree or None, update count) of an optax chain of
    add_decayed_weights / trace / scale_by_learning_rate / a multiplier."""
    trace, count = None, 0
    for s in opt_state:
        fields = getattr(s, "_fields", ())      # optax states: NamedTuples
        if "trace" in fields:
            trace = s.trace
        if "count" in fields:
            count = int(np.asarray(s.count))
    return trace, count


def _load_optimizer(opt, opt_state) -> None:
    trace, count = _chain_states(opt_state)
    opt.count = count
    if trace is not None:
        opt.set_momentum_buffers(from_jax_variables(trace))


@torch.no_grad()
def load_train_state(state, jstate: Any) -> Any:
    """Load a JAX adaptation ``TrainState`` (``jax.device_get`` of it, or
    any object with its fields as numpy trees) into the port's
    ``engine.state.TrainState`` ``state``, built for the same model and
    config: student parameters and frozen leaves, SGD momentum and update
    count, the EMA teacher, the prototypes, the CKG parameters with their
    momentum and count, and the step number."""
    dev = next(state.model.parameters()).device
    student = from_jax_variables(_merge_trees(jstate.params, jstate.frozen))
    state.model.load_state_dict(student, strict=True)
    teacher = from_jax_variables(_merge_trees(jstate.teacher_params,
                                              jstate.frozen))
    state.teacher.load_state_dict(teacher, strict=True)
    state.merge_model.load_state_dict(from_jax_variables(
        jstate.merge_params), strict=True)
    _load_optimizer(state.optimizer, jstate.opt_state)
    _load_optimizer(state.merge_optimizer, jstate.merge_opt_state)
    p = jstate.prototypes
    state.prototypes = type(state.prototypes)(
        *(torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
          for x in (p.proto, p.b_online, p.b_offline)))
    state.step = int(np.asarray(jstate.step))
    return state
