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
