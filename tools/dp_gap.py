"""Where two data-parallel ranks part from one process, on one card.

    python tools/dp_gap.py [--variants shipped_2,shipped_1,...]

``chip_smoke.py`` phase 20 (c) holds two ranks over gloo on one card
(foggy_fast.yaml, a batch of 4 split 2 + 2, the int8 res5's global scale)
against the single-process trainer on the same 4-image batches. This
script runs that comparison for variants of the configuration and prints,
for each, every tensor's largest difference over its largest entry: the
largest over the parameters that start at zero (their values are their
updates), over the others and over the prototypes, and the six worst
tensors. The variants:

- ``shipped_2``: the configuration of phase 20 (c), 2 cached steps;
- ``shipped_1``: the same, 1 cached step;
- ``f32res5_2``: TPU.INT8_TRAIN off (res5 in the compute dtype), 2 steps;
- ``f32_1``: TPU.COMPUTE_DTYPE float32, 1 step;
- ``f32_f32res5_1``: both, 1 step.

Needs a CUDA card and two processes on it (the default compute mode).
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

VARIANTS = {
    "shipped_2": (2, {}),
    "shipped_1": (1, {}),
    "f32res5_2": (2, {"TPU.INT8_TRAIN": False}),
    "f32_1": (1, {"TPU.COMPUTE_DTYPE": "float32"}),
    "f32_f32res5_1": (1, {"TPU.COMPUTE_DTYPE": "float32",
                          "TPU.INT8_TRAIN": False}),
}


def _cfg(root, npz, out, overrides):
    import chip_smoke
    cfg = chip_smoke._dp_cfg(root, npz, 4, out)
    for key, value in overrides.items():
        node = cfg
        *path, last = key.split(".")
        for part in path:
            node = getattr(node, part)
        setattr(node, last, value)
    return cfg


def _rank(rank: int, spec_path: str) -> None:
    """One of the two ranks: gloo on card 0, the variant's steps."""
    import torch
    import torch.distributed as dist
    import chip_smoke
    with open(spec_path) as f:
        spec = json.load(f)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=spec["init"], rank=rank,
                            world_size=2)
    try:
        npz = chip_smoke._dp_data(spec["root"])
        steps, overrides = VARIANTS[spec["variant"]]
        state, _, _ = chip_smoke._dp_train(
            torch, _cfg(spec["root"], npz, spec["run"], overrides), steps,
            chip_smoke._dp_counters(), "quantize_given_cuda")
        if rank == 0:
            torch.save(state, spec["out"])
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    import torch
    import chip_smoke
    from coin_tpu_torch.kernels import build
    if not torch.cuda.is_available():
        print("dp_gap: needs a CUDA card", file=sys.stderr)
        return 1
    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    root = tempfile.mkdtemp(prefix="dp_gap_")
    npz = chip_smoke._dp_data(root)
    for name in args.variants.split(","):
        steps, overrides = VARIANTS[name]
        t0 = time.perf_counter()
        before = {}
        want, _, _ = chip_smoke._dp_train(
            torch, _cfg(root, npz, os.path.join(root, "single", name),
                        overrides), steps, chip_smoke._dp_counters(),
            "quantize_cuda", before)
        spec = {"root": root, "variant": name,
                "init": f"file://{root}/store_{name}",
                "run": os.path.join(root, "dp", name),
                "out": os.path.join(root, f"rank0_{name}.pt")}
        spec_path = os.path.join(root, f"spec_{name}.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             spec_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        logs = [p.communicate(timeout=600)[0] for p in procs]
        if any(p.returncode for p in procs):
            print(f"{name}: a rank failed\n" + "\n".join(
                log[-3000:] for log in logs))
            return 1
        got = torch.load(spec["out"], weights_only=False)
        errs = chip_smoke._dp_errs(torch, got, want, before)
        entry = {k: float((got[k] - want[k]).abs().max()
                          / want[k].abs().max().clamp_min(1e-30))
                 for k in want}
        worst = sorted(entry.items(), key=lambda kv: kv[1])[-6:]
        print(f"{name} ({steps} step{'s' if steps > 1 else ''}, "
              f"{json.dumps(overrides)}): zero-start "
              f"{errs['zero_start_entry']:.3g}, others "
              f"{errs['other_entry']:.3g}, prototypes "
              f"{errs['prototypes_entry']:.3g}; worst {json.dumps(worst)}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _rank(int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
