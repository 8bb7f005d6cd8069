"""Device and dtype policy of the port.

Entry points take ``device="cuda"`` by default and raise when CUDA is
absent; the CPU is used only when the caller passes ``device="cpu"`` (the
tests do). The compute dtype follows ``TPU.COMPUTE_DTYPE``
(coin_tpu/config.py:245): bf16 on the card.
"""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; raises for CUDA without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "coin_tpu_torch: CUDA was requested but torch.cuda.is_available()"
            " is false; pass device='cpu' to run the plain versions")
    return device


def compute_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.get_path("TPU.COMPUTE_DTYPE", "bfloat16")]


def parity_numerics() -> None:
    """Full-f32 convolutions and matmuls for runs held against the JAX
    package: cuDNN convolutions default to TF32 on Hopper."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
