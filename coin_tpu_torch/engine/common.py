"""Copy of ``simple_class_tokens`` (coin_tpu/engine/common.py:34-55)."""

from __future__ import annotations

import numpy as np


def simple_class_tokens(num_classes_with_bg: int, context_length: int = 77,
                        prompt_tmp_len: int = 4,
                        add_prompt_num: int = 4) -> np.ndarray:
    """Synthetic per-class token table for runs without real CLIP weights:
    layout matches the learnable-prompt template
    [SOS][tmpl×4][X×4][cls][EOT][pad...] so the prompted path exercises the
    same slicing as with real CLIP tokens."""
    c = num_classes_with_bg
    toks = np.zeros((c, context_length), np.int32)
    sot, eot = 400, 500
    toks[:, 0] = sot
    for i in range(c):
        pos = 1
        for t in range(prompt_tmp_len):
            toks[i, pos] = 10 + t
            pos += 1
        for t in range(add_prompt_num):
            toks[i, pos] = 30 + t
            pos += 1
        toks[i, pos] = 100 + i
        toks[i, pos + 1] = eot
    return toks
