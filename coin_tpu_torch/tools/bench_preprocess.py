"""Time the device-side preprocessing kernels on one card (counterpart of
the repo's tools/bench_preprocess.py).

    python -m coin_tpu_torch.tools.bench_preprocess [--batch 3]
        [--iters 50] [--out FILE] [--device cuda|cpu]

``normalize_flip`` (K10b) runs as the JAX tool runs it: a batch of random
u8 images on the 608 x 1216 canvas with random flip flags and the tool's
mean and std. ``resize_bilinear`` (K10a) runs at the Foggy Cityscapes
shape: one 1024 x 2048 u8 image at scale 600 / 1024 into the 608 x 1216
canvas. Each is timed as the best of 3 rounds of ``--iters`` back-to-back
calls, from CUDA events around the round (the host clock on the CPU),
divided by ``--iters``.

Prints one JSON line with the JAX tool's keys (``shape``, ``jnp_ms``,
``jnp_gbps``, ``note``: there the jnp function, here K10b) and the
resize's (``resize_shape``, ``resize_ms``, ``resize_gbps``); GB/s count
each input byte read and each output byte written once. Runs on the card
unless ``--device cpu`` (the plain versions), and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from coin_tpu_torch.device import resolve_device
from coin_tpu_torch.ops.preprocess import normalize_flip, resize_bilinear

CANVAS = (608, 1216)
FOGGY_HW = (1024, 2048)
FOGGY_SCALE = 600 / 1024
# tools/bench_preprocess.py:49-50
MEAN = (0.481, 0.457, 0.408)
STD = (0.268, 0.261, 0.275)


def best_ms(fn, iters: int, device: torch.device, rounds: int = 3) -> float:
    """Best over ``rounds`` of the mean time of one call in ``iters``
    back-to-back calls, after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(rounds):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / iters)
    return best


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=3)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    b, (h, w) = args.batch, CANVAS
    rng = np.random.RandomState(0)
    images = torch.from_numpy(
        rng.randint(0, 255, (b, h, w, 3)).astype(np.uint8)).to(device)
    flip = torch.from_numpy(rng.rand(b) > 0.5).to(device)
    image = torch.from_numpy(
        rng.randint(0, 256, FOGGY_HW + (3,)).astype(np.uint8)).to(device)

    with torch.inference_mode():
        nf_ms = best_ms(lambda: normalize_flip(images, flip, MEAN, STD),
                        args.iters, device)
        rs_ms = best_ms(lambda: resize_bilinear(image, FOGGY_SCALE, CANVAS),
                        args.iters, device)
    nf_bytes = b * h * w * 3 * (1 + 4)
    rs_bytes = image.numel() + h * w * 3 * 4
    report = {
        "shape": [b, h, w, 3],
        "jnp_ms": nf_ms,
        "jnp_gbps": round(nf_bytes / nf_ms / 1e6, 1),
        "note": f"jnp_* time the port's normalize_flip (K10b) on "
                f"{device.type}; resize_* its resize_bilinear (K10a)",
        "resize_shape": [*FOGGY_HW, 3, h, w],
        "resize_ms": rs_ms,
        "resize_gbps": round(rs_bytes / rs_ms / 1e6, 1),
    }
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
