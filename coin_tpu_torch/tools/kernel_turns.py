"""Time K2's quantisation work over one res5 forward and backward, K1b,
the RoIAlign backward, K1, the RoIAlign forward, K3, greedy NMS, K4, the
strong and weak views, and K5b, the int8 RoIAlign backward, in two
checkouts of the port, in turns on one card (the other checkout, this one,
this one, the other), so that a redesigned kernel is compared with the one
it replaces in one run.

    python -m coin_tpu_torch.tools.kernel_turns --other DIR [--turns 4]
        [--rois FILE]

Each turn is a process started in one checkout, with that checkout's
``coin_tpu_torch`` first on the path, that runs this file's ``measure`` and
prints one JSON line; this process prints every line and, last, one JSON
summary. ``measure`` takes either quantiser:
- this tree's, which writes K2 wgrad's layout beside the s8 values, reads
  the bf16 gradient as it arrives and quantises both weights in one launch;
- the one before it: an f32 cast of each gradient, a memset and two kernels
  per tensor, one launch per weight quantisation, and the wgrad's own
  layout pass over both s8 tensors.
Work per res5 conv of mode 1 (bf16 activation and cotangent, N = 1728):
everything between the bf16 tensors and the s8 operands of the forward,
dgrad and wgrad GEMMs; device time from CUDA-graph replays, summed over
res5's ten convs, with the kernels and memsets of one pass counted by the
profiler. K1b: chip_smoke.py's shapes (3 x 576 random RoIs of 2-600 px, 20
of them shifted off the image, 14 x 14 x 1024 bf16). K1 on res4 of 38 x 76
x 1024 bf16: eval RoIs drawn as chip_smoke.py draws them (4 x 1000 random
RoIs of 2-600 px, 20 shifted off the image) and, with ``--rois FILE``, the
RoIs of the trainer path's first cached step (3 x 576) and of the
teacher's first collection batch (4 x 512) as ``chip_smoke.py
--save-rois FILE`` saves them. K3 on sorted random boxes of 4-300 px on
the 608 x 1216 canvas: eval's RPN (4 x 6000, IoU 0.7), the trainer's (3 x
6000), the teacher's (4 x 3000) and the box head's 4 x 1024 (0.5), each
with its two launches' device times from the profiler. K4 through each
checkout's own ``augment_cuda`` on chip_smoke.py's batch (3 x 608 x 1216
u8): both views with every gate on and with mixed gates, and the strong
view alone where the checkout's launcher takes ``weak``; device time from
CUDA-graph replays beside events around each call. K5b at K1b's random
RoIs and, with ``--rois``, the trainer's. K1, K1b, K3 and K5b: the median
of CUDA events around 20 calls. The card's name and power limit are in
each line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

RES5_N = 1728
# (H, in channels, out channels, k, convs): chip_smoke.RES5_SHAPES
RES5_SHAPES = ((14, 1024, 512, 1, 1), (14, 512, 512, 3, 1),
               (7, 1024, 2048, 1, 1), (7, 512, 2048, 1, 3),
               (7, 2048, 512, 1, 2), (7, 512, 512, 3, 2))
SEED = 2024


def graph_ms(torch, fn, iters: int = 10, reps: int = 5) -> float:
    """Median device time of one call of ``fn`` over ``reps`` replays of a
    CUDA graph of ``iters`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def device_ops(torch, fn) -> int:
    """Kernels and memsets that one call of ``fn`` puts on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def events_ms(torch, fn, iters: int = 20) -> float:
    """Median of CUDA events around each of ``iters`` calls of ``fn``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_device_ms(torch, fn, name: str, iters: int = 20):
    """Device ms per call of ``fn`` of the kernels whose names hold
    ``name``, from the profiler over ``iters`` back-to-back calls; None
    where the trace holds none of them (the profiler drops a kernel's
    records now and then)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and name in e.key)
    return us / 1e3 / iters if us else None


def random_rois(torch, gen, b, n, lo, hi):
    """(b, n, 4) RoIs on the 608 x 1216 canvas with sides uniform in
    [lo, hi] px, as chip_smoke.random_boxes draws them."""
    xy = torch.rand((b, n, 2), generator=gen) * torch.tensor([1216., 608.])
    wh = lo + torch.rand((b, n, 2), generator=gen) * (hi - lo)
    return torch.cat([xy, xy + wh], -1)


def measure_k1_k3(torch, dev, rois_file):
    """K1 at the eval RoIs, the trainer's and the teacher's; K3 at the RPN
    and box-head shapes (see the module's docstring)."""
    from coin_tpu_torch.kernels.nms import nms_sorted_cuda
    from coin_tpu_torch.kernels.roi_align import roi_align_cuda
    cpu = torch.Generator().manual_seed(SEED + 1)
    feats = torch.randn((4, 38, 76, 1024), generator=cpu).to(dev,
                                                            torch.bfloat16)
    eval_rois = random_rois(torch, cpu, 4, 1000, 2.0, 600.0)
    eval_rois[:, :20] -= 40.0
    rois = {"eval": eval_rois, **(torch.load(rois_file) if rois_file
                                  else {})}
    out = {}
    for label, r in rois.items():
        r = r.to(dev, torch.float32)
        f = feats[:r.shape[0]]
        out[f"k1_{label}_ms"] = events_ms(
            torch, lambda: roi_align_cuda(f, r, 1.0 / 16.0, 14, 2))
    for label, b, n, thr in (("4x6000", 4, 6000, 0.7), ("3x6000", 3, 6000,
                                                          0.7),
                             ("4x3000", 4, 3000, 0.7),
                             ("4x1024", 4, 1024, 0.5)):
        boxes = random_rois(torch, cpu, b, n, 4.0, 300.0) + 1.0
        order = torch.sort(torch.rand((b, n), generator=cpu), dim=-1,
                           descending=True).indices
        sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).to(
            dev)
        counts = torch.full((b,), n, dtype=torch.int32, device=dev)

        def call():
            return nms_sorted_cuda(sb, counts, thr, False)
        out[f"k3_{label}_ms"] = events_ms(torch, call)
        out[f"k3_{label}_mask_ms"] = kernel_device_ms(torch, call,
                                                      "nms_mask_kernel")
        out[f"k3_{label}_sweep_ms"] = kernel_device_ms(torch, call,
                                                       "nms_sweep_kernel")
    return out


def measure_k4(torch, dev):
    """K4 on a blocky batch of 3 on the 608 x 1216 canvas through the
    checkout's own launcher (see the module's docstring)."""
    from coin_tpu_torch.data.augment import (CLIP_MEAN, CLIP_STD,
                                             augment_params)
    from coin_tpu_torch.kernels.augment import augment_cuda
    cpu = torch.Generator().manual_seed(SEED + 2)
    cells = torch.randint(0, 256, (3, 38, 76, 3), generator=cpu,
                          dtype=torch.uint8)
    noise = torch.randint(0, 32, (3, 608, 1216, 3), generator=cpu,
                          dtype=torch.uint8)
    images = (cells.repeat_interleave(16, 1).repeat_interleave(16, 2) // 2
              + noise).to(dev)
    rest = 0.6 + torch.rand((3, 5), generator=cpu) \
        * torch.tensor([0.8, 0.8, 0.8, 0.0, 1.4])
    rest[:, 3] = 0.05
    out = {}
    cases = {"all_on": ([[1, 1, 1, 1]] * 3, True),
             "mixed": ([[1, 0, 1, 0], [0, 1, 0, 1], [1, 1, 0, 1]], True)}
    if "weak" in inspect.signature(augment_cuda).parameters:
        cases["strong_only"] = (cases["mixed"][0], False)
    for label, (gates, weak) in cases.items():
        on = torch.where(torch.tensor(gates) != 0, 0.0, 0.99)
        params = augment_params(torch.cat([on, rest], 1).to(dev))
        kw = {} if weak else {"weak": False}

        def call():
            return augment_cuda(images, params, CLIP_MEAN, CLIP_STD, **kw)
        out[f"k4_{label}_ms"] = graph_ms(torch, call)
        out[f"k4_{label}_events_ms"] = events_ms(torch, call)
    return out


def measure_k5b(torch, dev, rois, grad, rois_file):
    """K5b at K1b's random RoIs and the trainer's (see the module's
    docstring)."""
    from coin_tpu_torch.kernels.roi_align import roi_align_int8_backward_cuda
    args = ((3, 38, 76, 1024), torch.bfloat16, 1.0 / 16.0, 14, 2)
    out = {"k5b_ms": events_ms(torch, lambda: roi_align_int8_backward_cuda(
        grad, rois, *args))}
    if rois_file:
        r = torch.load(rois_file)["trainer"].to(dev, torch.float32)
        g = grad[:, :r.shape[1]]           # the trainer's 3 x 576 RoIs
        out["k5b_trainer_ms"] = events_ms(
            torch, lambda: roi_align_int8_backward_cuda(g, r, *args))
    return out


def quant_step(kq, x, w, g, k):
    """One conv's quantisation work of mode 1, with either quantiser."""
    if hasattr(kq, "quantize_weight_pair_cuda"):
        def step():
            kq.quantize_cuda(x, False, k)
            kq.quantize_weight_pair_cuda(w)
            kq.quantize_cuda(g, False, k)
    else:
        def step():
            xq = kq.quantize_cuda(x, False)[0]
            kq.quantize_weight_cuda(w, False)
            gq = kq.quantize_cuda(g.float(), False)[0]
            kq.quantize_weight_cuda(w, True)
            kq.wgrad_layout_cuda(xq, k)
            kq.wgrad_layout_cuda(gq, k)
    return step


def measure(rois_file=None) -> dict:
    import torch
    from coin_tpu_torch.kernels import qconv as kq
    from coin_tpu_torch.kernels.roi_align import roi_align_backward_cuda
    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns: no CUDA card")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    cases, total, ops = [], 0.0, 0
    for h, ci, co, k, convs in RES5_SHAPES:
        x = torch.randn((RES5_N, h, h, ci), generator=gen, device=dev,
                        dtype=bf16).relu_()
        g = (torch.randn((RES5_N, h, h, co), generator=gen, device=dev)
             * 1e-4).to(bf16)
        w = torch.randn((co, ci, k, k), generator=gen, device=dev) \
            / (ci * k * k) ** 0.5
        step = quant_step(kq, x, w, g, k)
        ms = graph_ms(torch, step)
        n_ops = device_ops(torch, step)
        cases.append(dict(case=f"{h}x{h} {ci}->{co} k{k}", convs=convs,
                          ms=ms, device_ops=n_ops))
        total += ms * convs
        ops += n_ops * convs
        del x, g, w, step
        torch.cuda.empty_cache()
    x = torch.randn((RES5_N, 14, 14, 1024), generator=gen, device=dev,
                    dtype=bf16)
    input_ms = graph_ms(torch, lambda: kq.quantize_cuda(x, False))
    del x
    # K1b at chip_smoke.phase_roi_align_bwd's shapes
    cpu = torch.Generator().manual_seed(SEED)
    xy = torch.rand((3, 576, 2), generator=cpu) * torch.tensor([1216., 608.])
    wh = 2.0 + torch.rand((3, 576, 2), generator=cpu) * 598.0
    rois = torch.cat([xy, xy + wh], -1)
    rois[:, :20] -= 40.0
    rois = rois.to(dev)
    grad = torch.randn((3, 576, 14, 14, 1024), generator=gen, device=dev,
                       dtype=bf16)
    args = ((3, 38, 76, 1024), bf16, 1.0 / 16.0, 14, 2)
    k1b_ms = events_ms(torch, lambda: roi_align_backward_cuda(grad, rois,
                                                              *args))
    k5b = measure_k5b(torch, dev, rois, grad, rois_file)
    del grad
    torch.cuda.empty_cache()
    return dict(tree=os.getcwd(), card=smi, quant_step_ms=total,
                quant_step_device_ops=ops, quant_cases=cases,
                quant_res5_input_ms=input_ms, k1b_ms=k1b_ms, **k5b,
                **measure_k4(torch, dev),
                **measure_k1_k3(torch, dev, rois_file))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the checkout to compare with")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--measure", action="store_true",
                    help="measure the checkout in the working directory")
    ap.add_argument("--rois", help="K1's trainer and teacher RoIs (K5b "
                    "takes the trainer's), as chip_smoke.py --save-rois "
                    "writes them")
    a = ap.parse_args()
    if a.measure:
        print(json.dumps(measure(a.rois)))
        return
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    other = os.path.abspath(a.other)
    order = [other, here, here, other] * (a.turns // 4) \
        + [other, here][:a.turns % 4]
    runs = []
    for tree in order:
        env = dict(os.environ, PYTHONPATH=tree)
        cmd = [sys.executable, os.path.abspath(__file__), "--measure"]
        if a.rois:
            cmd += ["--rois", os.path.abspath(a.rois)]
        out = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                             text=True)
        if out.returncode:
            raise SystemExit(f"kernel_turns: the turn in {tree} failed:\n"
                             f"{out.stderr[-4000:]}")
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    # every key of either checkout (one may time a case the other lacks)
    keys = [k for k in dict.fromkeys(k for r in runs for k in r)
            if k.endswith("_ms") or k.endswith("_ops")]
    print(json.dumps({side: {k: [r[k] for r in runs
                                 if r["tree"] == tree and k in r]
                             for k in keys}
                      for side, tree in (("other", other), ("this", here))}))


if __name__ == "__main__":
    main()
