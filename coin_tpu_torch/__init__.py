"""coin_tpu_torch — the PyTorch/CUDA port of coin_tpu for NVIDIA Hopper.

Mirrors coin_tpu's layout (ops/, models/, data/, engine/, evaluation/).
It imports torch, numpy, yaml and PIL, and nothing of JAX or coin_tpu.
Entry points run on CUDA unless the caller passes ``device="cpu"``; on a
CUDA tensor every kernel-backed op launches its hand-written kernel
(``kernels/``, sources in ``csrc/``) or raises.
"""
