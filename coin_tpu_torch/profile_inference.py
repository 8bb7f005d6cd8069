"""Kernel-level profile of the port's eval batch on one CUDA card.

    python -m coin_tpu_torch.profile_inference [--iters 5]

Builds the full-width bf16 detector of configs/coin/GDINO/foggy_fast.yaml
with random weights from a seed, and profiles ``--iters`` calls of
``normalize_batch`` + ``engine.pipelines.inference`` on one batch of random
u8 images already on the card (host decode excluded; the text features
are computed once beforehand, as ``evaluate_detector`` does). Prints the
device time per batch by kernel group and the top kernels, and the
device's busy share of the window: the kernels' summed time over the
host's wall time (the port launches on one stream, so kernels do not
overlap). Raises without a card, and when the profiler records no
device time.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from coin_tpu_torch.config import load_config
from coin_tpu_torch.data.augment import normalize_batch
from coin_tpu_torch.data.voc import CITYSCAPES_CLASSES
from coin_tpu_torch.device import resolve_device
from coin_tpu_torch.engine import pipelines
from coin_tpu_torch.engine.common import simple_class_tokens

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs/coin/GDINO/foggy_fast.yaml")
SEED = 2024

# kernel name fragment → group, first match wins
GROUPS = (
    ("port kernels", ("roi_align_fwd_kernel", "nms_mask_kernel",
                      "nms_sweep_kernel", "normalize_kernel")),
    ("elementwise", ("elementwise", "vectorized")),
    ("reduction", ("reduce",)),
    ("sort / top-k", ("sort", "radix", "topk", "scan")),
    ("pooling", ("pool",)),
    ("convolution", ("fprop", "conv", "implicit")),
    ("matmul", ("gemm", "nvjet", "cutlass", "cublas")),
    ("copy / layout", ("memcpy", "memset", "copy", "nchw", "nhwc")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, frags in GROUPS:
        if any(f in low for f in frags):
            return group
    return "other"


def profile_batches(iters: int, device="cuda"):
    """(wall ms per batch, {kernel name: (ms per batch, launches per
    batch)}) over ``iters`` profiled batches."""
    device = resolve_device(device)
    cfg = load_config(CONFIG)
    num_classes = len(CITYSCAPES_CLASSES)
    pcfg = pipelines.pipeline_config_from(cfg, num_classes)
    model = pipelines.build_detector(cfg, num_classes, device)
    model.random_init(SEED)
    gen = torch.Generator().manual_seed(SEED)
    h, w = cfg.TPU.IMAGE_HW
    images_u8 = torch.randint(0, 256, (4, h, w, 3), generator=gen,
                              dtype=torch.uint8).to(device)
    image_hw = torch.tensor([[h, w]] * 4, dtype=torch.float32, device=device)
    tokens = torch.as_tensor(simple_class_tokens(num_classes + 1),
                             device=device)
    with torch.inference_mode():
        text = model.text_features(tokens)

        def batch():
            return pipelines.inference(model, normalize_batch(images_u8),
                                       image_hw, tokens, pcfg,
                                       text_features=text)
        for _ in range(2):
            batch()
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                batch()
            torch.cuda.synchronize(device)
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            kernels[e.key] = (e.self_device_time_total / 1e3 / iters,
                              e.count / iters)
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    return wall_ms, kernels


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args()
    wall_ms, kernels = profile_batches(args.iters)
    busy = sum(ms for ms, _ in kernels.values())
    print(f"{torch.cuda.get_device_name(0)}: one eval batch (4 images, bf16)"
          f" {wall_ms:.3f} ms wall, {busy:.3f} ms of kernels: device busy "
          f"{100 * busy / wall_ms:.1f} %, idle {100 - 100 * busy / wall_ms:.1f}"
          f" % (over {args.iters} batches)")
    groups = defaultdict(float)
    for name, (ms, _) in kernels.items():
        groups[group_of(name)] += ms
    print("device ms per batch by kernel group:")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {group:16s} {ms:9.3f} ms  {100 * ms / busy:5.1f} %")
    print("top kernels, ms and launches per batch:")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        print(f"  {ms:9.3f} ms  {n:5.1f}x  [{group_of(name)}] {name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
