"""K8's arithmetic emulated in numpy at GLIP's reduction length: how far
3xTF32, an f32 SGEMM and one TF32 pass land from an f64 product, as a
share of max |out|, and how well the weights' TF32 split gives them back.

    python -m tests.tf32_emulation [--seed 0]

M = 2048 positions, K = 9 x 256 (a 3x3 conv over 256 channels), N = 256;
A is a standard normal sample times a sigmoid mask, B ~ N(0, 1/48**2) (the
scale of chip_smoke.py's K8 weights). TF32 rounding is to nearest with ties
away from zero onto 10 mantissa bits, as ``cvt.rna.tf32.f32`` rounds.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

M, K, N = 2048, 9 * 256, 256


def tf32(x: np.ndarray) -> np.ndarray:
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    rng = np.random.RandomState(ap.parse_args().seed)
    a = (rng.randn(M, K) / (1 + np.exp(-rng.randn(M, K)))).astype(np.float32)
    b = (rng.randn(K, N) / 48).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    f64 = lambda x: x.astype(np.float64)
    exact = f64(ah) @ f64(bh) + f64(ah) @ f64(bl) + f64(al) @ f64(bh)
    # the three passes of each k8 step summed exactly, rounded to f32, and
    # the steps added in f32
    per_step = np.zeros((M, N), np.float32)
    for k in range(0, K, 8):
        s = slice(k, k + 8)
        per_step += (f64(ah[:, s]) @ f64(bh[s]) + f64(ah[:, s]) @ f64(bl[s])
                     + f64(al[:, s]) @ f64(bh[s])).astype(np.float32)
    err = lambda x: float(np.abs(x - ref).max() / scale)
    w = (rng.randn(3, 3, 256, 256) / 48).astype(np.float32)
    wh = tf32(w)
    wl = tf32(w - wh)
    print(json.dumps({
        "shape": [M, K, N],
        "three_tf32_exact_sums": err(exact),
        "three_tf32_f32_sum_per_k8_step": err(per_step),
        "f32_sgemm": err(a @ b),
        "one_tf32_pass": err(f64(ah) @ f64(bh)),
        "weight_split_max_rel_err": float(np.max(
            np.abs(f64(w) - f64(wh) - f64(wl)) / np.abs(w))),
        "weight_split_bound": 2.0 ** -22}))


if __name__ == "__main__":
    main()
