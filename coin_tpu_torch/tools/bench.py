"""The port's bench: adaptation throughput of one card, from repeated
calls, with medians and spreads (counterpart of the repo's bench.py).

    python -m coin_tpu_torch.tools.bench [--only GROUP ...] [--repeats N]

Groups (all by default), each built by ``coin_tpu_torch.profile_device``'s
call builders, so that the profiler and the bench time the same calls:

- ``fast``: configs/coin/GDINO/foggy_fast.yaml at full width, batch 3 on
  608 x 1216 (int8 res5 training, int8 collection): ``cached_i8``,
  ``cached_two_i8`` and ``collect_i8``, the teacher's int8 collection call
  on the same batch.
- ``parity``: configs/coin/GDINO/foggy.yaml (bf16): ``cached``,
  ``cached_two``, ``live`` and ``collect``.
- ``int8_roi``: the cached steps of foggy_fast.yaml's int8train_ps
  (``cached_i8ps``) and int8train_ps_roi (``cached_i8roi``) arms, one
  state each, in alternation on one batch (A B, then B A, ...).
- ``eval``: the eval batch of 4. ``gdino``, ``glip``: the GDINO and
  GLIP-L collection batches of 4 (random weights in the official
  layouts). ``clip``: the CLIP re-scoring batch of 4, both views.
- ``preprocess``: the port's tools/bench_preprocess (K10a, K10b), with
  its own timing.

Each flavour runs one warm-up call and then ``--repeats`` (at least 10)
calls, each timed on the host clock from a ``torch.cuda.synchronize()``
before it to one after it. The line reports each flavour's median, min
and max ms and the count, and the images per second of the median.

Prints the card's name and power limit (``nvidia-smi``), then one JSON
line shaped like bench.py's: ``metric``, ``value``, ``unit``. The value
weights the flavours as bench.py does (``sched`` and ``eff_refresh``):
the shipped recipe, foggy_fast.yaml's int8 cached steps before burn-up
and its int8 cached_two steps after it, each image after burn-up also
paying 2 / REFRESH_EPOCHS int8 collection passes. It is null when
``--only`` leaves out the ``fast`` group. Raises without a card; a
flavour that fails ends the run with its error.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Optional

import torch

from coin_tpu_torch.device import resolve_device

# foggy.yaml's schedule and foggy_fast.yaml's refresh (bench.py:62, :413)
BURN_UP, MAX_ITER = 45000, 65000
REFRESH_EPOCHS = 4
BATCH = 3
GROUPS = ("fast", "parity", "int8_roi", "eval", "gdino", "glip", "clip",
          "preprocess")
MIN_REPEATS = 10


def sched(rate_one: float, rate_two: float, batch: int = BATCH) -> float:
    """Images/s over the whole schedule: step_one (BURN_UP steps) at
    ``rate_one``, step_two (the rest) at ``rate_two`` (bench.py:426-428)."""
    img_one = BURN_UP * batch
    img_two = (MAX_ITER - BURN_UP) * batch
    return (img_one + img_two) / (img_one / rate_one + img_two / rate_two)


def eff_refresh(collect_rate: float, step_rate: float) -> float:
    """step_two's images/s when every trained image also pays 2 collection
    passes (both orientations) every REFRESH_EPOCHS epochs
    (bench.py:413-417)."""
    return 1.0 / (1.0 / step_rate + 2.0 / (REFRESH_EPOCHS * collect_rate))


def summarize(times_ms: List[float]) -> Dict[str, float]:
    return {"median_ms": statistics.median(times_ms),
            "min_ms": min(times_ms), "max_ms": max(times_ms),
            "n": len(times_ms)}


def _timed(fn: Callable, device) -> float:
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def time_flavours(calls: Dict[str, Callable], repeats: int, device,
                  alternate: bool = False) -> Dict[str, List[float]]:
    """One warm-up call each, then ``repeats`` timed calls each: one
    flavour after the other, or with ``alternate`` in rounds that visit
    the flavours in turn, reversing the order every round."""
    for fn in calls.values():
        fn()
    times: Dict[str, List[float]] = {name: [] for name in calls}
    if alternate:
        names = list(calls)
        for r in range(repeats):
            for name in (names if r % 2 == 0 else names[::-1]):
                times[name].append(_timed(calls[name], device))
    else:
        for name, fn in calls.items():
            times[name] = [_timed(fn, device) for _ in range(repeats)]
    return times


def _group_calls(group: str, device):
    """({flavour: closure}, {flavour: images per call}, alternate)."""
    from coin_tpu_torch import profile_device as pd
    if group in ("fast", "parity"):
        config = ("GDINO/foggy_fast.yaml" if group == "fast"
                  else "GDINO/foggy.yaml")
        c = pd.train_calls(device, config)
        names = (("cached", "cached_two", "collect") if group == "fast"
                 else ("cached", "cached_two", "live", "collect"))
        suffix = "_i8" if group == "fast" else ""
        return ({n + suffix: c[n] for n in names},
                {n + suffix: c["batch"] for n in names}, False)
    if group == "int8_roi":
        ps = pd.train_calls(device, tpu=pd.INT8_PS)
        roi = pd.train_calls(device, tpu=pd.INT8_PS_ROI)
        return ({"cached_i8ps": ps["cached"], "cached_i8roi": roi["cached"]},
                {"cached_i8ps": ps["batch"], "cached_i8roi": roi["batch"]},
                True)
    name, build = {"eval": ("eval", pd.eval_call),
                   "gdino": ("collect_gdino", pd.collect_call),
                   "glip": ("collect_glip", pd.collect_glip_call),
                   "clip": ("rescore_clip", pd.clip_call)}[group]
    return {name: build(device)}, {name: 4}, False


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    first line."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def headline(rates: Dict[str, float]) -> Dict[str, Optional[float]]:
    """The recipe rates of bench.py from per-flavour images/s; a rate whose
    flavours were not run is None."""
    def has(*names):
        return all(n in rates for n in names)
    return {
        "value": (sched(rates["cached_i8"], eff_refresh(
            rates["collect_i8"], rates["cached_two_i8"]))
            if has("cached_i8", "cached_two_i8", "collect_i8") else None),
        "parity_recipe": (sched(rates["cached"], rates["live"])
                          if has("cached", "live") else None),
        "weighted_refresh": (sched(rates["cached"], eff_refresh(
            rates["collect"], rates["cached_two"]))
            if has("cached", "cached_two", "collect") else None),
    }


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", nargs="+", choices=GROUPS, default=list(GROUPS))
    p.add_argument("--repeats", type=int, default=MIN_REPEATS)
    args = p.parse_args(argv)
    if args.repeats < MIN_REPEATS:
        p.error(f"--repeats must be at least {MIN_REPEATS}")
    device = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)

    flavours: Dict[str, Dict[str, float]] = {}
    rates: Dict[str, float] = {}
    report: Dict = {}
    for group in args.only:
        if group == "preprocess":
            from coin_tpu_torch.tools import bench_preprocess
            report["preprocess"] = bench_preprocess.main(
                ["--iters", str(args.repeats)])
            continue
        calls, images, alternate = _group_calls(group, device)
        times = time_flavours(calls, args.repeats, device, alternate)
        for name, t in times.items():
            flavours[name] = summarize(t)
            rates[name] = images[name] / (flavours[name]["median_ms"] / 1e3)
            print(f"[{group}] {name}: " + json.dumps(flavours[name]),
                  flush=True)
        del calls
        gc.collect()
        torch.cuda.empty_cache()

    rated = headline(rates)
    out = {"metric": "adaptation_images_per_sec_per_chip",
           "value": rated.pop("value"), "unit": "images/sec/chip", **rated,
           "device": card, "batch": BATCH, "repeats": args.repeats,
           "flavours": flavours, "images_per_sec": rates, **report}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
