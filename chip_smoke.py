#!/usr/bin/env python3
"""Smoke run of coin_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py [--save-rois FILE]

(``--save-rois`` writes the RoIs of K1's recorded calls, phase 3, for
``python -m coin_tpu_torch.tools.kernel_turns --rois FILE``.) Phases, each of which ends the run with a non-zero exit when it fails:

1. device: CUDA is required (there is no CPU path); prints the card's name
   and power limit as nvidia-smi reports them.
2. build: compiles every kernel from coin_tpu_torch/csrc with nvcc (one
   process per source, all at once).
3. kernels: each kernel against its plain PyTorch version on the same card
   inputs at the shapes of its main path (eval, foggy_fast: 4 images on a
   608 x 1216 canvas, 6000/1000 RPN boxes, 1024 box-head candidates;
   training: 3 images, 512 + 64 RoIs each, so 1728 crops through res5;
   collection: 4 images, the stem and a backbone 3x3 conv; the GDINO
   collection batch: K9 at every Swin-B stage, K7 at the encoder's and the
   decoder's shape, K6 on 4 x 256 rows; the int8 RoIAlign K5 at the
   student's 3 x 576 RoIs, the teacher's 4 x 512 and transposed, and its
   backward K5b; K11 on 4 x 512 boxes with real clusters), with its median
   time, the plain version's, a library call's where PyTorch has one, and
   the card's bound. The int8 kernels (quantisation, K2 forward, dgrad and
   wgrad at each res5 shape, K2s, K5) and K11 must agree bit for bit; the
   quantiser also writes K2 wgrad's layout at every res5 shape (byte for
   byte) and quantises both weights of each res5 conv in one launch, and
   the sum of its launches over one res5 forward and backward is timed
   from CUDA-graph replays. K1, K1b and K5b are also timed on the RoIs of
   the trainer path's first cached step (phase 8), and K1 on the teacher's
   4 x 512 proposals of its first collection batch, recorded as it runs.
   K4 runs with both views (every gate on; mixed gates), with the strong
   view alone (the cached flavours' call) and on an odd canvas, its device
   time from CUDA-graph replays apart from the host's launch. K3
   runs at eval's 4 x 6000 RPN boxes, the trainer's 3 x 6000, the
   teacher's 4 x 3000 and the box head's 4 x 1024, with the split between
   its two launches (the mask and the sweep) and the time of the sorts and
   gathers of nms_keep_mask around them.
4. reference: the full-width detector in f32 on the card against the same
   weights on the CPU (plain versions throughout) on a small canvas.
5. step reference: one train_step_cached and one train_step of the
   full-width f32 model on the card against the CPU, same weights and
   draws, on a small canvas; then one train_step_cached with the int8 res5
   of foggy_fast.yaml, and one of the int8train_ps_roi configuration
   (per-sample int8 res5, the int8 RoIAlign K5 and K5b).
6. eval path: evaluate_detector of the full-width CLIP-RN50
   OpenVocabularyRCNN (bf16 with int8 res5, random weights from a seed)
   over a synthetic 8-image Foggy-Cityscapes-classed VOC set read through
   configs/coin/GDINO/foggy_fast.yaml; K1, K3, K4n and the K2 forward must
   launch.
7. training path: build_adaptation_steps at full width from
   configs/coin/GDINO/foggy.yaml (bf16, batch 3 on 608 x 1216, 128 cloud
   boxes per image): cached steps, then live and cached_two steps past a
   moved burn-up; K1, K1b, K3, K4 and K4n must launch; ms per step of each
   flavor and a stage breakdown of the cached step.
8. trainer path, the main path: CoinTrainer.train of
   configs/coin/GDINO/foggy_fast.yaml as shipped (int8 res5 training, int8
   collection, the 512-proposal teacher, refresh every 4 epochs) at full
   width over a synthetic 12-image train set and 4-image val set at
   1024 x 2048 with a synthetic cloud store read from an npz; burn-up at
   step 4, so 8 steps are a collection pass, 4 cached steps, a refresh and
   4 cached_two steps, then an eval of the student and the teacher. Every
   kernel must launch. Prints ms per step of each flavor, a stage split of
   the cached step, the collection pass per image with INT8_COLLECT on and
   off, peak memory, and checks a checkpoint save and restore. Then the
   collection pass with TPU.TEACHER_SHARE_CROPS 512 from the trained
   teacher: its store must equal the plain pass bit for bit (every
   proposal is its own cluster after the RPN's NMS) and K11 must launch.
8b. int8 RoI path, this slice's main path: CoinTrainer.train of the
   int8train_ps_roi arm of tools/validate_cached_teacher.py (foggy_fast.yaml
   with TPU.INT8_TRAIN_SCALE sample, INT8_TRAIN_WGRAD false, INT8_ROI) at
   full width, 8 steps as in phase 8; K5 and K5b must launch, K1 and K1b
   must not. Then the same 8 steps of int8train_ps (INT8_ROI off), and the
   two cached steps in turns on one batch.
9. GDINO reference: the full-width Swin-B GroundingDINO and BERT-base in
   f32 on the card against the CPU, stage by stage, on 2 x 192 x 256.
10. collection path: build_cloud_detector of foggy_fast.yaml's GDINO
   teacher from a random checkpoint file in the official layout (Swin-B,
   900 queries, 6 + 6 layers, BERT-base, bf16 over f32 parameters), then
   collect_cloud with the Probabilistic-Fusion NMS over the 12 synthetic
   1024 x 2048 images; the npz read back as the trainer reads it. K4n, K6,
   K7 and K9 must launch. Prints ms per image, device ms per batch, a
   stage split and detections before and after K6.
11. GLIP reference: the full-width Swin-L GLIP (8 VLDyHead blocks) and
   BERT-base in f32 on the card against the CPU, stage by stage (Swin,
   FPN, each block, head, post-processing), on 2 x 192 x 256.
12. GLIP collection path: build_cloud_detector of
   configs/coin/GLIP/foggy.yaml's teacher from a random GLIP-L checkpoint
   file in the official layout (Swin-L, 8 blocks, BERT-base, bf16 over f32
   parameters), then collect_cloud with the Probabilistic-Fusion NMS over 8
   synthetic 1024 x 2048 images; the npz read back as the trainer reads
   it. K4n, K9, K8, K3 and K6 must launch. Prints ms per image, device ms
   per batch, a stage split (Swin, FPN, the blocks' VLFuse, language layer
   and DyConv, head and post-processing), detections before and after K6,
   peak memory, and the checkpoint's write and build seconds.

13. bench_preprocess path, the main path of K10: the port's
   tools/bench_preprocess through its main (normalize_flip of 3 x 608 x
   1216 u8 images, resize_bilinear of a 1024 x 2048 u8 image into the 608
   x 1216 canvas); K10a and K10b must launch.
14. CLIP reference: the full-width CLIP RN50 scorer (backbone, K1 on res4,
   res5, attention pool) and its 12-layer text trunk in f32 on the card
   against the CPU, on 2 x 128 x 192.
15. CLIP re-scoring path (stage 1b): build_clip_scorer of foggy_fast.yaml
   from a random checkpoint in OpenAI CLIP RN50's layout and a BPE merges
   file of the prompts' words (TPU.CLIP_WEIGHTS and TPU.CLIP_BPE_VOCAB set
   in code), then rescore_with_clip over phase 10's 12-image store; the
   CLIP_collect.npz read back. K1 and K4n must launch. Prints ms per image
   and the rows before and after.

Phase 3 also holds K8 (the modulated deformable 3x3 conv of the GLIP
teacher) at each of its call shapes in GLIP-L's collection batch against
its plain version, and K10 (the bilinear resize K10a at the Foggy
Cityscapes shape, an upscale and an f32 rounding tie of the scaled extent,
with F.interpolate's antialiased resize timed beside it; the normalise +
flip K10b bit for bit). The script prints its own wall time.

The second-to-last line is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or coin_tpu.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 2024
# published peaks of one H100 SXM at 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12         # dense bf16 tensor-core operations
INT8_OPS = 1979e12          # dense int8 tensor-core operations


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS):
    """Least time on the card (ms) and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each."""
    for _ in range(warmup):
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


def device_ms(torch, fn, kernels=(), iters: int = 20, warmup: int = 3):
    """Device time of one call of ``fn`` from the profiler's trace of
    ``iters`` back-to-back calls, free of the host's launch time: (ms per
    call of the kernels whose names hold one of ``kernels``, or of every
    kernel and copy when it is empty; their launches per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0 \
                and (not kernels or any(k in e.key for k in kernels)):
            us += e.self_device_time_total
            n += e.count
    check(us > 0, f"the profiler recorded no device time of {kernels}")
    return us / 1e3 / iters, n / iters


def graph_ms(torch, fn, iters: int = 10, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events; the median
    replay over ``iters``. Free of the host's launch time, as a stream of
    back-to-back launches would be, without the profiler."""
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


def random_boxes(torch, gen, shape, hw, min_wh, max_wh):
    h, w = hw
    xy = torch.rand(shape + (2,), generator=gen) \
        * torch.tensor([w, h], dtype=torch.float32)
    wh = min_wh + torch.rand(shape + (2,), generator=gen) * (max_wh - min_wh)
    return torch.cat([xy, xy + wh], -1)


# ----------------------------------------------------------- kernel phases
def phase_roi_align(torch, dev, gen):
    from coin_tpu_torch.kernels.roi_align import roi_align_cuda
    from coin_tpu_torch.ops.roi_align import roi_align_plain
    # main path: res4 of 4 images at 608x1216 (38x76x1024 bf16), 1000
    # proposals each, 14x14 output, sampling ratio 2
    feats = torch.randn((4, 38, 76, 1024), generator=gen).to(dev, torch.bfloat16)
    rois = random_boxes(torch, gen, (4, 1000), (608, 1216), 2.0, 600.0)
    rois[:, :20] -= 40.0                     # partly outside the image
    rois = rois.to(dev)
    args = (1.0 / 16.0, 14, 2)
    # the arithmetic itself, in f32 on the rois of one image
    f32 = feats[:1].float()
    e32 = (roi_align_cuda(f32, rois[:1], *args)
           - roi_align_plain(f32, rois[:1], *args)).abs().max().item()
    check(e32 <= 1e-5, f"roi_align f32: max abs err {e32} > 1e-5")
    # bf16: both sides accumulate in f32 (in another order) and round
    # once, so they differ by at most one bf16 ulp of the larger of the two
    # plus the f32 difference (bounded by the f32 check above)
    got = roi_align_cuda(feats, rois, *args).float()
    want = roi_align_plain(feats, rois, *args).float()
    err = (got - want).abs()
    tol = torch.ldexp(torch.ones_like(want), torch.frexp(
        torch.maximum(got.abs(), want.abs())).exponent - 8) + 1e-5
    worst = int((err / tol).argmax())
    check(bool((err <= tol).all()),
          f"roi_align bf16: {int((err > tol).sum())} values over 1 ulp + "
          f"1e-5, worst got {got.flatten()[worst].item()} want "
          f"{want.flatten()[worst].item()}")
    ms = time_ms(torch, lambda: roi_align_cuda(feats, rois, *args))
    plain_ms = time_ms(torch, lambda: roi_align_plain(feats, rois, *args),
                       iters=3, warmup=1)
    out_elems = got.numel()
    nbytes = feats.numel() * 2 + rois.numel() * 4 + out_elems * 2
    b_ms, b_by = bound(nbytes, out_elems * 4 * 4 * 2)  # 4 samples x 4 taps
    print(f"[K1 roi_align] feats {tuple(feats.shape)} bf16, rois "
          f"{tuple(rois.shape)} -> {tuple(got.shape)}: max abs err "
          f"{err.max().item():.3g} (tol 1 bf16 ulp + 1e-5), f32 err "
          f"{e32:.3g} "
          f"(tol 1e-5); {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    return dict(name="roi_align", route="cuda",
                source="coin_tpu_torch/csrc/roi_align.cu",
                replaces="coin_tpu/ops/roi_align.py:54",
                max_abs_err=max(err.max().item(), e32), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def nms_split_ms(torch, call, iters: int = 20):
    """Median device ms of K3's mask and sweep launches: ``call(mid)`` runs
    the launcher, which records ``mid`` between them; a sleep on the card
    ahead of the events keeps the host's launch time out of them."""
    for _ in range(3):
        call(None)
    mid = torch.cuda.Event(enable_timing=True)
    mid.record()                       # creates the event the launcher records
    mask, sweep = [], []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        call(mid)
        end.record()
        end.synchronize()
        mask.append(start.elapsed_time(mid))
        sweep.append(mid.elapsed_time(end))
    return statistics.median(mask), statistics.median(sweep)


def _nms_case(torch, dev, gen, label, n, thr, classes, hw, max_wh,
              batch=4):
    from coin_tpu_torch.kernels.nms import nms_sorted_cuda
    from coin_tpu_torch.ops import nms as nms_ops
    boxes = random_boxes(torch, gen, (batch, n), hw, 4.0, max_wh).to(dev)
    scores = torch.rand((batch, n), generator=gen).to(dev)
    valid = (torch.rand((batch, n), generator=gen) < 0.95).to(dev)
    cls = (torch.randint(0, 8, (batch, n), generator=gen).to(dev)
           if classes else None)
    got = nms_ops.nms_keep_mask(boxes, scores, valid, thr, classes=cls)
    # the same wrapper on CPU tensors runs the plain version
    want = nms_ops.nms_keep_mask(boxes.cpu(), scores.cpu(), valid.cpu(),
                                 thr, classes=None if cls is None
                                 else cls.cpu())
    diff = (got.cpu() != want).sum().item()
    check(diff == 0, f"nms {label}: {diff} keep entries differ")
    check(0 < int(want.sum()) < int(valid.sum()),
          f"nms {label}: degenerate case")
    # time the kernel and the plain version on the same sorted boxes
    b = boxes.clone()
    if cls is not None:
        b = nms_ops._offset_by_class(b, cls, valid)
    b = torch.where(valid[..., None], b + 1.0, torch.zeros_like(b))
    order = torch.sort(torch.where(valid, scores, torch.full_like(
        scores, nms_ops.NEG_INF)), dim=-1, descending=True,
        stable=True).indices
    sboxes = torch.gather(b, 1, order[..., None].expand(-1, -1, 4))
    counts = valid.sum(-1, dtype=torch.int32)
    check(torch.equal(nms_sorted_cuda(sboxes, counts, thr, False).cpu(),
                      nms_ops.nms_sorted_plain(sboxes, counts, thr, False)
                      .cpu()), f"nms {label}: sorted masks differ")
    ms = time_ms(torch, lambda: nms_sorted_cuda(sboxes, counts, thr, False))
    plain_ms = time_ms(torch, lambda: nms_ops.nms_sorted_plain(
        sboxes, counts, thr, False), iters=2, warmup=1)
    # the device time of each launch (CUDA events, the launcher's between
    # them), and of the whole nms_keep_mask call (class offset, sorts,
    # gathers and the inverse scatter around K3)
    mask_ms, sweep_ms = nms_split_ms(torch, lambda mid: nms_sorted_cuda(
        sboxes, counts, thr, False, mid_event=mid))
    call_ms = time_ms(torch, lambda: nms_ops.nms_keep_mask(
        boxes, scores, valid, thr, classes=cls))
    pairs = sum(c * (c - 1) / 2 for c in counts.tolist())
    b_ms, b_by = bound(sboxes.numel() * 4 + 4 * batch + batch * n,
                       pairs * 15)
    print(f"[K3 nms {label}] {batch} x {n} boxes, IoU {thr}, class-aware "
          f"{classes}: keep masks identical ({int(want.sum())} kept); "
          f"{ms:.4f} ms (device: mask {mask_ms:.4f}, sweep {sweep_ms:.4f}), "
          f"plain {plain_ms:.3f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}); the whole nms_keep_mask call {call_ms:.4f}"
          f" ms, {call_ms - ms:.4f} of it around the kernels")
    return dict(case=label, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, mask_ms=mask_ms, sweep_ms=sweep_ms,
                call_ms=call_ms)


def phase_nms(torch, dev, gen):
    """K3 at eval's RPN (4 x 6000 at IoU 0.7) and box head (4 x 1024,
    class-aware, 0.5), then the trainer's RPN (3 x 6000) and the teacher's
    (TEACHER_PRE_NMS_TOPK: 4 x 3000), these two drawn from their own
    generator; the keep masks must equal the plain version's."""
    rpn = _nms_case(torch, dev, gen, "rpn", 6000, 0.7, False, (608, 1216),
                    300.0)
    box = _nms_case(torch, dev, gen, "box_head", 1024, 0.5, True,
                    (608, 1216), 200.0)
    own = torch.Generator().manual_seed(SEED + 13)
    trainer = _nms_case(torch, dev, own, "trainer_rpn", 6000, 0.7, False,
                        (608, 1216), 300.0, batch=3)
    teacher = _nms_case(torch, dev, own, "teacher_rpn", 3000, 0.7, False,
                        (608, 1216), 300.0)
    return dict(name="nms", route="cuda", source="coin_tpu_torch/csrc/nms.cu",
                replaces="coin_tpu/ops/nms.py:110", max_abs_err=0.0,
                ms=rpn["ms"], plain_ms=rpn["plain_ms"],
                bound_ms=rpn["bound_ms"], bound_by=rpn["bound_by"],
                library_ms=None, cases=[rpn, box, trainer, teacher])


def phase_normalize(torch, dev, gen):
    from coin_tpu_torch.data.augment import CLIP_MEAN, CLIP_STD, normalize_plain
    from coin_tpu_torch.kernels.normalize import normalize_cuda
    images = torch.randint(0, 256, (4, 608, 1216, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    got = normalize_cuda(images, CLIP_MEAN, CLIP_STD)
    want = normalize_plain(images)
    err = (got - want).abs().max().item()
    check(err <= 1e-5, f"normalize: max abs err {err} > 1e-5")
    ms = time_ms(torch, lambda: normalize_cuda(images, CLIP_MEAN, CLIP_STD))
    plain_ms = time_ms(torch, lambda: normalize_plain(images))
    n = images.numel()
    b_ms, b_by = bound(n + 4 * n, 3 * n)
    print(f"[K4n normalize] {tuple(images.shape)} u8 -> f32: max abs err "
          f"{err:.3g} (tol 1e-5); {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})")
    return dict(name="normalize", route="cuda",
                source="coin_tpu_torch/csrc/normalize.cu",
                replaces="coin_tpu/data/augment.py:123", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def phase_roi_align_bwd(torch, dev, gen):
    from coin_tpu_torch.kernels.roi_align import roi_align_backward_cuda
    from coin_tpu_torch.ops.roi_align import roi_align_backward_plain
    # training path: res4 of 3 images at 608x1216, 512 sampled + 64 C
    # boxes each, 14x14 crops, bf16 gradient
    shape = (3, 38, 76, 1024)
    rois = random_boxes(torch, gen, (3, 576), (608, 1216), 2.0, 600.0)
    rois[:, :20] -= 40.0                     # partly outside the image
    rois = rois.to(dev)
    g = torch.randn((3, 576, 14, 14, 1024), generator=gen).to(
        dev, torch.bfloat16)
    args = (1.0 / 16.0, 14, 2)
    # the arithmetic in f32 (both accumulate in f32, the kernel with
    # atomics in no fixed order): within 1e-5 of the largest |d feature|
    want = roi_align_backward_plain(g, rois, shape, torch.float32, *args)
    got = roi_align_backward_cuda(g, rois, shape, torch.float32, *args)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= 1e-5 * scale, f"roi_align_bwd: max abs err {err} > 1e-5 "
          f"x {scale}")
    ms = time_ms(torch, lambda: roi_align_backward_cuda(
        g, rois, shape, torch.bfloat16, *args))
    plain_ms = time_ms(torch, lambda: roi_align_backward_plain(
        g, rois, shape, torch.bfloat16, *args), iters=3, warmup=1)
    n = g.numel()
    b_ms, b_by = bound(2 * n + rois.numel() * 4 + 2 * 3 * 38 * 76 * 1024,
                       n * 4 * 4 * 2)          # 4 samples x 4 taps
    print(f"[K1b roi_align_bwd] grad {tuple(g.shape)} bf16, rois "
          f"{tuple(rois.shape)} -> {shape}: max abs err {err:.3g} (tol 1e-5 "
          f"x max |d feature| {scale:.3g}, f32); {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name="roi_align_bwd", route="cuda",
                source="coin_tpu_torch/csrc/roi_align_bwd.cu",
                replaces="coin_tpu/ops/roi_align.py:85", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def record_first_call(module, name, when=lambda x, rois: True):
    """Wrap ``module.name`` (a dispatch function that takes a tensor, the
    gradient or the features, and RoIs first) so that the RoIs and shapes
    of its first call for which ``when(tensor, rois)`` holds are kept;
    returns (the record, a function that puts the function back)."""
    orig = getattr(module, name)
    seen = {}

    def wrapper(x, rois, *args):
        if not seen and when(x, rois):
            seen.update(grad_shape=tuple(x.shape), grad_dtype=x.dtype,
                        rois=rois.detach().clone(), args=args)
        return orig(x, rois, *args)
    setattr(module, name, wrapper)
    return seen, lambda: setattr(module, name, orig)


def k1_on_recorded_rois(torch, dev, rec, label, seed):
    """K1 on RoIs recorded by ``record_first_call`` from the main path, with
    random features of that call's shape and dtype: within 1e-5 of the
    plain version in f32 on the first image, one bf16 ulp + 1e-5 in bf16,
    timed in the call's dtype."""
    from coin_tpu_torch.kernels.roi_align import roi_align_cuda
    from coin_tpu_torch.ops.roi_align import roi_align_plain
    check(bool(rec), f"the trainer path ran no RoIAlign of the {label}")
    rois = rec["rois"]
    args = rec["args"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn(rec["grad_shape"], generator=gen, device=dev).to(
        rec["grad_dtype"])
    f32 = feats[:1].float()
    e32 = (roi_align_cuda(f32, rois[:1], *args)
           - roi_align_plain(f32, rois[:1], *args)).abs().max().item()
    check(e32 <= 1e-5, f"roi_align on the {label}'s RoIs f32: max abs err "
          f"{e32} > 1e-5")
    got = roi_align_cuda(feats, rois, *args).float()
    want = roi_align_plain(feats, rois, *args).float()
    err = (got - want).abs()
    tol = torch.ldexp(torch.ones_like(want), torch.frexp(
        torch.maximum(got.abs(), want.abs())).exponent - 8) + 1e-5
    check(bool((err <= tol).all()), f"roi_align on the {label}'s RoIs: "
          f"{int((err > tol).sum())} values over 1 bf16 ulp + 1e-5")
    ms = time_ms(torch, lambda: roi_align_cuda(feats, rois, *args))
    plain_ms = time_ms(torch, lambda: roi_align_plain(feats, rois, *args),
                       iters=3, warmup=1)
    nbytes = (feats.numel() * feats.element_size() + rois.numel() * 4
              + got.numel() * feats.element_size())
    b_ms, _ = bound(nbytes, got.numel() * 4 * 4 * 2)
    side = (rois[..., 2:] - rois[..., :2]).float()
    print(f"[K1 roi_align, the {label}'s RoIs] feats {tuple(feats.shape)} "
          f"{feats.dtype}, rois {tuple(rois.shape)} (median side "
          f"{side.median().item():.1f} px) -> {tuple(got.shape)}: max abs "
          f"err {err.max().item():.3g} (tol 1 bf16 ulp + 1e-5), f32 err "
          f"{e32:.3g} (tol 1e-5); {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"bound {b_ms:.4f} ms (bytes)")
    return {f"{label}_ms": ms, f"{label}_plain_ms": plain_ms,
            f"{label}_bound_ms": b_ms,
            f"{label}_max_abs_err": max(err.max().item(), e32),
            f"{label}_rois": list(rois.shape)}


def k1b_on_trainer_rois(torch, dev, rec):
    """K1b on the RoIs of the trainer path's first cached step (recorded by
    ``record_first_call``) with a random gradient of that step's shape:
    within 1e-5 of the largest |d feature| of the plain version in f32,
    timed in the step's dtype."""
    from coin_tpu_torch.kernels.roi_align import roi_align_backward_cuda
    from coin_tpu_torch.ops.roi_align import roi_align_backward_plain
    check(bool(rec), "the trainer path ran no RoIAlign backward")
    rois = rec["rois"]
    shape, _, *args = rec["args"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    g = torch.randn(rec["grad_shape"], generator=gen, device=dev).to(
        rec["grad_dtype"])
    want = roi_align_backward_plain(g, rois, shape, torch.float32, *args)
    got = roi_align_backward_cuda(g, rois, shape, torch.float32, *args)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= 1e-5 * scale, f"roi_align_bwd on the trainer's RoIs: max "
          f"abs err {err} > 1e-5 x {scale}")
    del got, want
    dt = rec["grad_dtype"]
    ms = time_ms(torch, lambda: roi_align_backward_cuda(g, rois, shape, dt,
                                                        *args))
    plain_ms = time_ms(torch, lambda: roi_align_backward_plain(
        g, rois, shape, dt, *args), iters=3, warmup=1)
    n = g.numel()
    b_ms, b_by = bound(n * g.element_size() + rois.numel() * 4
                       + g.element_size() * math.prod(shape), n * 4 * 4 * 2)
    side = (rois[..., 2:] - rois[..., :2]).float()
    print(f"[K1b roi_align_bwd, the trainer's RoIs] grad {tuple(g.shape)} "
          f"{dt}, rois {tuple(rois.shape)} (median side "
          f"{side.median().item():.1f} px) -> {tuple(shape)}: max abs err "
          f"{err:.3g} (tol 1e-5 x {scale:.3g}, f32); {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(trainer_ms=ms, trainer_plain_ms=plain_ms,
                trainer_bound_ms=b_ms, trainer_max_abs_err=err,
                trainer_rois=list(rois.shape))


def k5b_on_trainer_rois(torch, dev, rec):
    """K5b on the RoIs of the trainer path's first cached step (recorded by
    ``record_first_call`` for K1b) with a random gradient of that step's
    shape: within 1e-5 of the largest |d feature| of the plain version in
    f32 and 2**-7 in bf16, timed in the step's dtype beside K1b."""
    from coin_tpu_torch.kernels.roi_align import (
        roi_align_backward_cuda, roi_align_int8_backward_cuda)
    from coin_tpu_torch.ops.roi_align import roi_align_int8_backward_plain
    check(bool(rec), "the trainer path ran no RoIAlign backward")
    rois = rec["rois"]
    shape, _, *args = rec["args"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    g = torch.randn(rec["grad_shape"], generator=gen, device=dev).to(
        rec["grad_dtype"])
    errs = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        got = roi_align_int8_backward_cuda(g, rois, shape, dt, *args).float()
        want = roi_align_int8_backward_plain(g, rois, shape, dt,
                                             *args).float()
        errs[str(dt)] = (got - want).abs().max().item() \
            / want.abs().max().item()
        check(errs[str(dt)] <= tol, f"roi_align_int8_bwd on the trainer's "
              f"RoIs {dt}: {errs[str(dt)]} of the largest entry > {tol}")
        del got, want
    dt = rec["grad_dtype"]
    ms = time_ms(torch, lambda: roi_align_int8_backward_cuda(
        g, rois, shape, dt, *args))
    k1b_ms = time_ms(torch, lambda: roi_align_backward_cuda(
        g, rois, shape, dt, *args))
    plain_ms = time_ms(torch, lambda: roi_align_int8_backward_plain(
        g, rois, shape, dt, *args), iters=2, warmup=1)
    n = g.numel()
    b_ms, _ = bound(n * g.element_size() + rois.numel() * 4
                    + g.element_size() * math.prod(shape), n * 4 * 2 * 2)
    print(f"[K5b roi_align_int8_bwd, the trainer's RoIs] grad "
          f"{tuple(g.shape)} {dt}, rois {tuple(rois.shape)} -> "
          f"{tuple(shape)}: error / largest entry {json.dumps(errs)} (tol "
          f"1e-5 f32, 2**-7 bf16); {ms:.4f} ms, K1b {k1b_ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms (bytes)")
    return dict(trainer_ms=ms, trainer_k1b_ms=k1b_ms,
                trainer_plain_ms=plain_ms, trainer_bound_ms=b_ms,
                trainer_max_abs_err=max(errs.values()),
                trainer_rois=list(rois.shape))


def phase_roi_align_int8(torch, dev, gen):
    """K5 at the student's shapes (3 images of res4 38 x 76 x 1024 bf16,
    512 + 64 RoIs each: 1728 crops), the teacher's (4 images, 512
    proposals each) and transposed (h > w, the other contraction order):
    bit for bit against the plain version; timed beside K1 at the same
    shapes."""
    from coin_tpu_torch.kernels.roi_align import (roi_align_cuda,
                                                  roi_align_int8_cuda)
    from coin_tpu_torch.ops.roi_align import roi_align_int8_plain
    args = (1.0 / 16.0, 14, 2)
    cases = []
    for label, b, n, hw in (("student", 3, 576, (38, 76)),
                            ("teacher", 4, 512, (38, 76)),
                            ("transposed", 3, 576, (76, 38))):
        feats = torch.randn((b,) + hw + (1024,), generator=gen).to(
            dev, torch.bfloat16)
        rois = random_boxes(torch, gen, (b, n), (16 * hw[0], 16 * hw[1]),
                            2.0, 600.0)
        rois[:, :20] -= 40.0                 # partly outside the image
        rois = rois.to(dev)
        got = roi_align_int8_cuda(feats, rois, *args)
        want = roi_align_int8_plain(feats, rois, *args)
        diff = int((got != want).sum())
        check(diff == 0 and bool(got.isfinite().all()),
              f"roi_align_int8 {label}: {diff} values differ")
        f32 = feats[:1].float()
        check(torch.equal(roi_align_int8_cuda(f32, rois[:1], *args),
                          roi_align_int8_plain(f32, rois[:1], *args)),
              f"roi_align_int8 {label} f32: values differ")
        ms = time_ms(torch, lambda: roi_align_int8_cuda(feats, rois, *args))
        k1_ms = time_ms(torch, lambda: roi_align_cuda(feats, rois, *args))
        plain_ms = time_ms(torch, lambda: roi_align_int8_plain(
            feats, rois, *args), iters=2, warmup=1)
        nbytes = feats.numel() * 2 + rois.numel() * 4 + got.numel() * 2
        # each output: <= 4 x 4 s8 taps of two contractions, the requant
        b_ms, b_by = bound(nbytes, got.numel() * 4 * 4 * 2 * 2, INT8_OPS)
        print(f"[K5 roi_align_int8 {label}] feats {tuple(feats.shape)} bf16, "
              f"rois {tuple(rois.shape)} -> {tuple(got.shape)}: bit for bit "
              f"(bf16 and f32); {ms:.4f} ms, K1 at the same shapes "
              f"{k1_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by})")
        cases.append(dict(case=label, ms=ms, k1_ms=k1_ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by))
    st = cases[0]
    return dict(name="roi_align_int8", route="cuda",
                source="coin_tpu_torch/csrc/roi_align_int8.cu",
                replaces="coin_tpu/ops/roi_align.py:188", max_abs_err=0.0,
                ms=st["ms"], plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
                bound_by=st["bound_by"], library_ms=None, k1_ms=st["k1_ms"],
                cases=cases)


def phase_roi_align_int8_bwd(torch, dev, gen):
    """K5b at the student's shapes, against the plain version: 1e-5 of the
    largest |d feature| in f32, 2**-7 in bf16 (f32 atomics in no fixed
    order; a t near a bf16 rounding boundary may round the other way);
    timed beside K1b."""
    from coin_tpu_torch.kernels.roi_align import (
        roi_align_backward_cuda, roi_align_int8_backward_cuda)
    from coin_tpu_torch.ops.roi_align import roi_align_int8_backward_plain
    shape = (3, 38, 76, 1024)
    rois = random_boxes(torch, gen, (3, 576), (608, 1216), 2.0, 600.0)
    rois[:, :20] -= 40.0
    rois = rois.to(dev)
    g = torch.randn((3, 576, 14, 14, 1024), generator=gen).to(
        dev, torch.bfloat16)
    args = (1.0 / 16.0, 14, 2)
    errs = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        got = roi_align_int8_backward_cuda(g, rois, shape, dt, *args).float()
        want = roi_align_int8_backward_plain(g, rois, shape, dt,
                                             *args).float()
        scale = want.abs().max().item()
        errs[str(dt)] = (got - want).abs().max().item() / scale
        check(errs[str(dt)] <= tol, f"roi_align_int8_bwd {dt}: "
              f"{errs[str(dt)]} of the largest entry > {tol}")
    ms = time_ms(torch, lambda: roi_align_int8_backward_cuda(
        g, rois, shape, torch.bfloat16, *args))
    k1b_ms = time_ms(torch, lambda: roi_align_backward_cuda(
        g, rois, shape, torch.bfloat16, *args))
    plain_ms = time_ms(torch, lambda: roi_align_int8_backward_plain(
        g, rois, shape, torch.bfloat16, *args), iters=2, warmup=1)
    n = g.numel()
    b_ms, b_by = bound(2 * n + rois.numel() * 4 + 2 * math.prod(shape),
                       n * 4 * 2 * 2)        # <= 4 taps per axis
    print(f"[K5b roi_align_int8_bwd] grad {tuple(g.shape)} bf16, rois "
          f"{tuple(rois.shape)} -> {shape}: error / largest entry "
          f"{json.dumps(errs)} (tol 1e-5 f32, 2**-7 bf16); {ms:.4f} ms, K1b "
          f"{k1b_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
          f"({b_by})")
    return dict(name="roi_align_int8_bwd", route="cuda",
                source="coin_tpu_torch/csrc/roi_align_int8_bwd.cu",
                replaces="coin_tpu/ops/roi_align.py:213",
                max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, k1b_ms=k1b_ms)


def clustered_boxes(rng, n, thr=0.9):
    """(boxes (n, 4) f32, valid (n,) bool) with real clusters at IoU >= thr:
    exact duplicates, chains whose neighbours overlap at IoU >= thr while
    their ends do not (the closure must be transitive), invalid copies of
    members between them, zero-area boxes (and their copies: no IoU), and
    singletons, at shuffled indices. The kernel tests draw from it too."""
    import numpy as np
    rows, valid = [], []

    def box(x, y, w, h):
        return [x, y, x + w, y + h]

    while len(rows) < n:
        kind = rng.randint(5)
        x, y = rng.uniform(0, 900, 2)
        w, h = rng.uniform(20, 120, 2)
        if kind == 0:                                   # exact duplicates
            rows += [box(x, y, w, h)] * rng.randint(2, 4)
            valid += [True] * (len(rows) - len(valid))
        elif kind == 1:                                 # a chain along x
            # IoU of neighbours (w - d) / (w + d) >= thr, of the ends not
            d = w * (1 - thr) / (1 + thr) * 0.8
            rows += [box(x + k * d, y, w, h) for k in range(rng.randint(3, 6))]
            valid += [True] * (len(rows) - len(valid))
        elif kind == 2:                                 # invalid copies
            rows += [box(x, y, w, h)] * 3
            valid += [True, False, True]
        elif kind == 3:                                 # zero area
            rows += [box(x, y, 0.0, h)] * 2
            valid += [True, True]
        else:                                           # a singleton
            rows.append(box(x, y, w, h))
            valid.append(rng.uniform() > 0.1)
    perm = rng.permutation(len(rows))[:n]
    return (np.asarray(rows, np.float32)[perm],
            np.asarray(valid, bool)[perm])


def phase_self_cluster(torch, dev):
    """K11 at the teacher's shapes (4 images x 512 proposals, IoU 0.9) on
    boxes with real clusters (duplicates, chains, invalid rows between
    members, zero-area boxes): keep and rep equal the plain closure's."""
    import numpy as np
    from coin_tpu_torch.kernels.dedup import self_cluster_cuda
    from coin_tpu_torch.ops.boxes import pairwise_iou
    from coin_tpu_torch.ops.dedup import self_cluster_index_plain
    rng = np.random.RandomState(SEED)
    pairs = [clustered_boxes(rng, 512) for _ in range(4)]
    boxes = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    valid = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
    keep, rep = self_cluster_cuda(boxes, valid, 0.9)
    want_keep, want_rep = self_cluster_index_plain(boxes, valid, 0.9)
    check(torch.equal(keep, want_keep) and torch.equal(rep, want_rep),
          f"self_cluster: {int((rep != want_rep).sum())} representatives, "
          f"{int((keep != want_keep).sum())} keeps differ")
    # real clusters, some reached only through the closure
    idx = torch.arange(512, device=dev).expand(4, -1)
    joined = (rep != idx) & valid
    iou = pairwise_iou(boxes, boxes)
    chained = joined & (torch.gather(iou, 2, rep[..., None])[..., 0] < 0.9)
    check(int(joined.sum()) > 0 and int(chained.sum()) > 0,
          "self_cluster: the inputs hold no clusters or no chains")
    ms = time_ms(torch, lambda: self_cluster_cuda(boxes, valid, 0.9))
    plain_ms = time_ms(torch, lambda: self_cluster_index_plain(
        boxes, valid, 0.9), iters=5, warmup=1)
    # the IoU of every pair (about 15 f32 operations) is the least work;
    # inputs boxes + valid, outputs keep + rep
    b_ms, b_by = bound(boxes.numel() * 4 + valid.numel() * (1 + 1 + 8),
                       4 * 512 * 511 / 2 * 15)
    print(f"[K11 self_cluster] 4 x 512 boxes, IoU 0.9: keep and rep "
          f"identical ({int(keep.sum())} clusters of {int(valid.sum())} "
          f"valid boxes; {int(chained.sum())} members joined only through "
          f"a chain); {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{b_ms:.5f} ms ({b_by})")
    return dict(name="self_cluster", route="cuda",
                source="coin_tpu_torch/csrc/dedup.cu",
                replaces="coin_tpu/ops/dedup.py:38", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def _augment_draws(torch, gen, gates):
    """(B, 9) draws with the gates forced (1 = on) and the rest drawn."""
    g = torch.tensor(gates, dtype=torch.float32)
    on = torch.where(g != 0, 0.0, 0.99)
    u = torch.rand((len(gates), 5), generator=gen)
    lo = torch.tensor([0.6, 0.6, 0.6, -0.1, 0.1])
    hi = torch.tensor([1.4, 1.4, 1.4, 0.1, 2.0])
    return torch.cat([on, lo + u * (hi - lo)], 1)


def host_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median host time of one call of ``fn`` (its launches enqueued, the
    card not waited for), each call after a synchronize."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def phase_augment(torch, dev, gen):
    """K4 at the training path's batch of 3 on the 608 x 1216 canvas: both
    views with every gate on and with mixed gates (the live step's call),
    the strong view alone (the cached flavours' call), and an odd canvas
    (H and W off the 16 x 64 tiles, rows off 16 bytes) with mixed gates;
    each within 1e-5 of the plain version. Device time from CUDA-graph
    replays, apart from the host's time to launch one call and from CUDA
    events around each call."""
    from coin_tpu_torch.data.augment import (CLIP_MEAN, CLIP_STD,
                                             augment_params,
                                             preprocess_plain)
    from coin_tpu_torch.kernels.augment import augment_cuda

    def blocky(hw):
        cells = torch.randint(0, 256, (3, hw[0] // 16 + 1, hw[1] // 16 + 1,
                                       3), generator=gen, dtype=torch.uint8)
        noise = torch.randint(0, 32, (3,) + hw + (3,), generator=gen,
                              dtype=torch.uint8)
        big = cells.repeat_interleave(16, 1).repeat_interleave(16, 2)
        return (big[:, :hw[0], :hw[1]] // 2 + noise).to(dev)
    train = blocky((608, 1216))
    mixed = [[1, 0, 1, 0], [0, 1, 0, 1], [1, 1, 0, 1]]
    cases = (("all_on", train, [[1, 1, 1, 1]] * 3, True),
             ("mixed", train, mixed, True),
             ("strong_only", train, mixed, False),
             ("odd", blocky((605, 1211)), mixed, True))
    out = {}
    for label, images, gates, weak in cases:
        params = augment_params(_augment_draws(torch, gen, gates).to(dev))
        call = lambda: augment_cuda(images, params, CLIP_MEAN, CLIP_STD,
                                    weak)
        got = call()
        want = preprocess_plain(images, params, weak)
        check(got[1] is None if not weak else got[1] is not None,
              f"augment {label}: the weak view is {got[1]}")
        err = max((a - b).abs().max().item() for a, b in zip(got, want)
                  if a is not None)
        check(err <= 1e-5, f"augment {label}: max abs err {err} > 1e-5")
        ms = graph_ms(torch, call)
        call_ms = time_ms(torch, call)
        launch_ms = host_ms(torch, call)
        plain_ms = time_ms(torch, lambda: preprocess_plain(images, params,
                                                           weak),
                           iters=5, warmup=1)
        n = images.numel()
        on = torch.tensor(gates).sum(0).tolist()
        # operations the function needs per channel value with these
        # gates: jitter ~20, gray 5, the two 9-tap passes 36, solarize and
        # the normalisations 3 per view
        per = [20 * gates[i][0] + 5 * gates[i][1] + 36 * gates[i][2]
               + 3 * (2 if weak else 1) for i in range(len(gates))]
        flops = n / len(gates) * sum(per)
        b_ms, b_by = bound(n + (2 if weak else 1) * 4 * n, flops)
        print(f"[K4 augment {label}] {tuple(images.shape)} u8 -> "
              f"{'2 x' if weak else 'strong'} f32, gates on per (jitter, "
              f"gray, blur, solarize) {on}: max abs err {err:.3g} (tol "
              f"1e-5); device {ms:.4f} ms (graph replays), events around "
              f"each call {call_ms:.4f} ms, host launch {launch_ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        out[label] = dict(case=label, max_abs_err=err, ms=ms,
                          call_ms=call_ms, host_ms=launch_ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    a = out["all_on"]
    return dict(name="augment", route="cuda",
                source="coin_tpu_torch/csrc/augment.cu",
                replaces="coin_tpu/data/augment.py:106",
                max_abs_err=max(c["max_abs_err"] for c in out.values()),
                ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
                bound_by=a["bound_by"], library_ms=None,
                cases=list(out.values()))


# res5 (layer4) of RN50 over the 1728 crops of a foggy_fast training step
# (3 images x (512 + 64) RoIs): (H = W, I, O, k, convs of that shape)
RES5_N = 1728
RES5_SHAPES = ((14, 1024, 512, 1, 1), (14, 512, 512, 3, 1),
               (7, 1024, 2048, 1, 1), (7, 512, 2048, 1, 3),
               (7, 2048, 512, 1, 2), (7, 512, 512, 3, 2))


def _int8_entry(name, source, replaces, cases, err=0.0):
    """A kernels-line entry of an int8 kernel whose numbers are the sums
    over ``cases`` weighted by their ``convs`` count (one res5 pass)."""
    tot = {k: sum(c[k] * c["convs"] for c in cases)
           for k in ("ms", "ms_f32", "plain_ms", "bound_ms", "library_ms")
           if all(k in c for c in cases)}
    by = ("operations" if sum(c["convs"] for c in cases
                              if c["bound_by"] == "operations")
          >= sum(c["convs"] for c in cases) / 2 else "bytes")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, bound_by=by, cases=cases, **tot)


def phase_quantize(torch, dev):
    """csrc/quantize.cu at the main path's shapes, every s8 value and scale
    against the plain version: the res5 input (bf16), the largest res5
    gradient in f32 and in bf16 (the dtype the backward reads), each per
    tensor and per sample; K2 wgrad's layout written by the same launch at
    every res5 shape (bf16 activation and gradient, N = 1728), byte for byte
    against ``wgrad_layout_plain(quantize_plain(x))``; both weight
    quantisations in one launch at every res5 weight shape, and the serving
    conv's per-output weights. Then the quant launches of one res5 forward
    and backward of mode 1 (per conv: the activation with its layout, both
    weights, the gradient with its layout), device time from CUDA-graph
    replays, summed over res5's convs beside their bound."""
    from coin_tpu_torch.kernels import qconv as kq
    from coin_tpu_torch.ops import qconv as tq
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    acts = {"res5_input_bf16": torch.randn((RES5_N, 14, 14, 1024),
                                           generator=g, device=dev,
                                           dtype=bf16),
            "res5_grad_f32": torch.randn((RES5_N, 7, 7, 2048), generator=g,
                                         device=dev) * 1e-4}
    acts["res5_grad_bf16"] = acts["res5_grad_f32"].to(bf16)
    cases = []
    for label, x in acts.items():
        for per_sample in (False, True):
            q, s = kq.quantize_cuda(x, per_sample)
            wq, ws = tq.quantize_plain(x, per_sample)
            check(torch.equal(q, wq) and torch.equal(s, ws),
                  f"quantize {label} per_sample={per_sample}: s8 values or "
                  f"scales differ from the plain version")
            del q, wq
        ms = time_ms(torch, lambda: kq.quantize_cuda(x, False))
        plain_ms = time_ms(torch, lambda: tq.quantize_plain(x, False),
                           iters=5, warmup=1)
        n = x.numel()
        b_ms, b_by = bound(n * x.element_size() + n + 4, 4 * n)
        cases.append(dict(case=label, shape=list(x.shape), ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"[quantize {label}] {tuple(x.shape)} {x.dtype} -> s8, per "
              f"tensor and per sample: s8 values and scales identical; "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by})")
    del acts
    for o, i, k in ((512, 512, 3), (2048, 512, 1)):
        w = torch.randn((o, i, k, k), generator=g, device=dev) / (i * k * k)
        check(all(torch.equal(a, b) for a, b in zip(
            kq.quantize_weight_cuda(w), tq.quantize_weight_plain(w))),
              f"quantize_weight {(o, i, k)} differs from the plain version")
    print("[quantize weights] (512, 512, 3, 3) and (2048, 512, 1, 1) per "
          "output channel (the serving conv's): identical")
    steps = []
    for h, ci, co, k, convs in RES5_SHAPES:
        x = torch.randn((RES5_N, h, h, ci), generator=g, device=dev,
                        dtype=bf16).relu_()
        grad = (torch.randn((RES5_N, h, h, co), generator=g, device=dev)
                * 1e-4).to(bf16)
        w = torch.randn((co, ci, k, k), generator=g, device=dev) \
            / (ci * k * k) ** 0.5
        for what, t in (("activation", x), ("gradient", grad)):
            q, s, lay = kq.quantize_cuda(t, False, k)
            wq, ws = tq.quantize_plain(t)
            check(torch.equal(q, wq) and torch.equal(s, ws)
                  and torch.equal(lay, tq.wgrad_layout_plain(wq, k)),
                  f"quantize with layout, {what} {tuple(t.shape)} k {k}: "
                  f"differs from wgrad_layout_plain(quantize_plain(x))")
            del q, lay, wq
        check(all(torch.equal(a, b) for a, b in zip(
            kq.quantize_weight_pair_cuda(w), tq.quantize_weight_pair_plain(w))),
              f"quantize_weight_pair {(co, ci, k)} differs from the plain "
              f"version")

        def step():
            kq.quantize_cuda(x, False, k)
            kq.quantize_weight_pair_cuda(w)
            kq.quantize_cuda(grad, False, k)
        ms = graph_ms(torch, step)
        pp = tq.wgrad_positions(RES5_N, h, h, k)
        nbytes = (3 * x.numel() + ci * pp + 3 * grad.numel() + co * pp
                  + 6 * w.numel() + 4 * (ci + co) + 8)
        b_ms, b_by = bound(nbytes, 4 * (x.numel() + grad.numel()))
        steps.append(dict(case=f"{h}x{h} {ci}->{co} k{k}", convs=convs,
                          ms=ms, bound_ms=b_ms, bound_by=b_by, launches=3))
        print(f"[quantize one conv of res5] N {RES5_N}, {h}x{h}, {ci} -> "
              f"{co}, {k}x{k} (x{convs}): activation and gradient (bf16) "
              f"with their layouts and both weights identical to the plain "
              f"versions; 3 launches {ms:.4f} ms (graph), bound "
              f"{b_ms:.4f} ms ({b_by})")
        del x, grad, w
        torch.cuda.empty_cache()
    step_ms = sum(c["ms"] * c["convs"] for c in steps)
    step_bound = sum(c["bound_ms"] * c["convs"] for c in steps)
    step_launches = sum(c["launches"] * c["convs"] for c in steps)
    print(f"[quantize] one res5 forward and backward (mode 1): "
          f"{step_launches} launches, {step_ms:.3f} ms (graph), bound "
          f"{step_bound:.3f} ms")
    a = cases[0]
    return dict(name="quantize", route="cuda",
                source="coin_tpu_torch/csrc/quantize.cu",
                replaces="coin_tpu/ops/qconv.py:63", max_abs_err=0.0,
                ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
                bound_by=a["bound_by"], library_ms=None, cases=cases,
                step_ms=step_ms, step_bound_ms=step_bound,
                step_launches=step_launches, step_cases=steps)


def phase_qconv(torch, dev):
    """K2 at every res5 shape of the training step, N = 1728 crops: the
    forward and the dgrad (csrc/qconv.cu's wgmma GEMM; the dgrad on the
    gradient's s8 and the flipped per-input-channel weights) in the bf16
    the main path writes and in f32, and the wgrad (csrc/qconv_wgrad.cu),
    each bit for bit against its plain version (whose bf16 output is its
    f32 output rounded). The forward's and the dgrad's times are device
    times of launches replayed from a CUDA graph (``graph_ms``), their
    bounds count the bf16 output's bytes. Library yardsticks, timed and
    used nowhere in the port: the cuDNN bf16 conv, dgrad and wgrad of the
    same shape (what the bf16 step runs), and torch._int_mm's s8 GEMM (s32
    out) for the 1x1 forwards."""
    from coin_tpu_torch.kernels import qconv as kq
    from coin_tpu_torch.ops import qconv as tq
    F = torch.nn.functional
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    n = RES5_N
    out = {"fwd": [], "dgrad": [], "wgrad": []}
    top = 0
    for h, ci, co, k, convs in RES5_SHAPES:
        p = k // 2
        x = torch.randn((n, h, h, ci), generator=g, device=dev,
                        dtype=bf16).relu_()
        w = torch.randn((co, ci, k, k), generator=g, device=dev) \
            / (ci * k * k) ** 0.5
        grad = torch.randn((n, h, h, co), generator=g, device=dev) * 1e-4
        xq, xs, xt = kq.quantize_cuda(x, False, k)
        wq, ks, wt, ki = kq.quantize_weight_pair_cuda(w)
        gq, gs, gt = kq.quantize_cuda(grad, False, k)
        runs = {
            "fwd": (lambda dt: kq.qconv_fwd_cuda(xq, wq, xs, ks, 1, p, dt),
                    lambda: tq.qconv_plain(xq, wq, xs, ks, 1, p)),
            "dgrad": (lambda dt: kq.qconv_dgrad_cuda(gq, wt, gs, ki, p, dt),
                      lambda: tq.qconv_plain(gq, wt, gs, ki, 1, p)),
            "wgrad": (lambda: kq.qconv_wgrad_cuda(xt, gt, xs, gs, n, h, h,
                                                  k),
                      lambda: tq.qconv_wgrad_plain(xq, gq, xs, gs, k)),
        }
        xb = x.permute(0, 3, 1, 2)
        wb = w.to(bf16).contiguous(memory_format=torch.channels_last)
        gb = grad.to(bf16).permute(0, 3, 1, 2)
        library = {
            "fwd": lambda: F.conv2d(xb, wb, padding=p),
            "dgrad": lambda: torch.nn.grad.conv2d_input(
                xb.shape, wb, gb, padding=p),
            "wgrad": lambda: torch.nn.grad.conv2d_weight(
                xb, wb.shape, gb, padding=p),
        }
        macs = n * h * h * ci * co * k * k
        nbytes = {"fwd": xq.numel() + wq.numel() + 2 * n * h * h * co,
                  "dgrad": gq.numel() + wt.numel() + 2 * n * h * h * ci,
                  "wgrad": xq.numel() + gq.numel() + 4 * w.numel()}
        for kind, (kernel, plain) in runs.items():
            want = plain()
            case = dict(case=f"{h}x{h} {ci}->{co} k{k}", convs=convs)
            if kind == "wgrad":
                got = kernel()
                check(torch.equal(got, want),
                      f"qconv wgrad {(n, h, ci, co, k)}: "
                      f"{int((got != want).sum())} values differ from the "
                      f"plain version")
                ms = time_ms(torch, kernel, iters=10)
                lib_ms = time_ms(torch, library[kind], iters=10)
            else:
                for dt in (bf16, torch.float32):
                    got = kernel(dt)
                    check(got.dtype == dt and torch.equal(got, want.to(dt)),
                          f"qconv {kind} {(n, h, ci, co, k)} {dt}: "
                          f"{int((got != want.to(dt)).sum())} values differ "
                          f"from the plain version")
                    del got
                ms = graph_ms(torch, lambda: kernel(bf16))
                case["ms_f32"] = graph_ms(torch, lambda: kernel(torch.float32))
                lib_ms = graph_ms(torch, library[kind])
            del want
            plain_ms = time_ms(torch, plain, iters=2, warmup=1)
            b_ms, b_by = bound(nbytes[kind] + 8, 2 * macs, INT8_OPS)
            case.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms,
                        tops=2 * macs / ms / 1e9)
            if kind == "fwd" and k == 1:
                a2, b2 = xq.view(-1, ci), wq.view(co, ci).t()
                case["int_mm_ms"] = graph_ms(torch,
                                             lambda: torch._int_mm(a2, b2))
            if kind == "wgrad":
                acc = tq.qconv_wgrad_s32_plain(xq, gq, k)
                case["max_abs_s32"] = int(acc.long().abs().max())
                top = max(top, case["max_abs_s32"])
                del acc
            out[kind].append(case)
            extra = "".join(f", {key} {case[key]:.4f}" if
                            isinstance(case[key], float) else
                            f", {key} {case[key]}" for key in
                            ("ms_f32", "int_mm_ms", "max_abs_s32")
                            if key in case)
            lib = "cuDNN bf16" + (" (graph)" if kind != "wgrad" else "")
            print(f"[K2 {kind}] N {n}, {h}x{h}, {ci} -> {co}, {k}x{k} (x"
                  f"{convs} in res5): identical to the plain version"
                  f"{' in bf16 and f32' if kind != 'wgrad' else ''}; "
                  f"{ms:.4f} ms ({case['tops']:.0f} TOPS), plain "
                  f"{plain_ms:.3f} ms, {lib} {lib_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}){extra}")
        del x, w, grad, xq, gq, xt, gt, wq, wt, xb, wb, gb
        torch.cuda.empty_cache()
    print(f"[K2 wgrad] largest |s32| sum met: {top} (2**31 = {2 ** 31})")
    for kind, cases in out.items():
        tot = {key: sum(c[key] * c["convs"] for c in cases if key in c)
               for key in ("ms", "ms_f32", "library_ms", "bound_ms")}
        print(f"[K2 {kind}] one res5 pass: {tot['ms']:.3f} ms"
              + (f" in bf16, {tot['ms_f32']:.3f} in f32" if kind != "wgrad"
                 else " (operands laid out by the quantiser)")
              + f", cuDNN bf16 {tot['library_ms']:.3f} ms, bound "
              f"{tot['bound_ms']:.3f} ms")
    ones = [c for c in out["fwd"] if "int_mm_ms" in c]
    int_mm = sum(c["int_mm_ms"] * c["convs"] for c in ones)
    ones_ms = sum(c["ms"] * c["convs"] for c in ones)
    print(f"[K2 fwd] the 1x1 convs of one res5 pass: {ones_ms:.3f} ms in "
          f"bf16, torch._int_mm (s32 out) {int_mm:.3f} ms")
    src = "coin_tpu_torch/csrc/qconv.cu"
    fwd = _int8_entry("qconv_fwd", src, "coin_tpu/ops/qconv.py:136",
                      out["fwd"])
    fwd.update(int_mm_ms=int_mm, ms_1x1=ones_ms)
    return [
        fwd,
        _int8_entry("qconv_dgrad", src, "coin_tpu/ops/qconv.py:170",
                    out["dgrad"]),
        _int8_entry("qconv_wgrad", "coin_tpu_torch/csrc/qconv_wgrad.cu",
                    "coin_tpu/ops/qconv.py:203", out["wgrad"])]


def backbone_convs(torch, dev, images=4, hw=(608, 1216)):
    """(input NCHW shape, weight shape, stride) of each of the CLIP-RN50
    backbone's 45 convs in one collection batch (``images`` on the
    ``hw`` canvas), as forward hooks see them."""
    from coin_tpu_torch.models.clip_resnet import CLIPResNetBackbone, QConv2d
    net = CLIPResNetBackbone(50).to(dev)
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: shapes.append((tuple(a[0].shape), tuple(m.weight.shape),
                                    m.stride[0])))
        for m in net.modules() if isinstance(m, QConv2d)]
    net(torch.zeros((images, *hw, 3), device=dev), torch.bfloat16)
    for hk in hooks:
        hk.remove()
    return shapes


def phase_int8_conv(torch, dev):
    """K2s over the 45 backbone convs of one collection call (4 images on
    the 608 x 1216 canvas; the stem conv1, 3x3 stride 2 from 3 channels,
    runs the direct kernel, the others the wgmma GEMM): each bit for bit
    against the plain version in the bf16 the collection pass writes and
    in f32, its device time in bf16 (``graph_ms``) beside the cuDNN bf16
    conv of the same shape; the stem conv1 and layer1's 3x3 (64 -> 64 at
    152 x 304) also timed in f32. The entry's numbers are the sums over the
    45 convs (per collection call); its bound counts the bf16 output's
    bytes."""
    from coin_tpu_torch.kernels import qconv as kq
    from coin_tpu_torch.ops import qconv as tq
    F = torch.nn.functional
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    shapes = backbone_convs(torch, dev)
    check(len(shapes) == 45, f"{len(shapes)} backbone convs, not 45")
    named = {0: "stem conv1", 4: "layer1 conv2"}
    check(shapes[0][1] == (32, 3, 3, 3) and shapes[4][1] == (64, 64, 3, 3),
          f"backbone convs 0 and 4: {shapes[0]}, {shapes[4]}")
    cases, tot = [], {}
    for i, ((n, ci, h, w_), (co, _, k, _), stride) in enumerate(shapes):
        p = k // 2
        x = torch.randn((n, h, w_, ci), generator=g, device=dev,
                        dtype=bf16).relu_()
        w = torch.randn((co, ci, k, k), generator=g, device=dev) \
            / (k * k * ci) ** 0.5
        xq, xs = kq.quantize_cuda(x, False)
        wq, ks = kq.quantize_weight_cuda(w)
        want = tq.qconv_plain(xq, wq, xs, ks, stride, p)
        for dt in (bf16, torch.float32):
            got = kq.int8_conv_cuda(xq, wq, xs, ks, stride, p, dt)
            check(torch.equal(got, want.to(dt)),
                  f"int8_conv {i} {(n, h, w_, ci, co, k, stride)} {dt}: "
                  f"{int((got != want.to(dt)).sum())} values differ from "
                  f"the plain version")
        ho, wo = want.shape[1:3]
        del got, want
        ms = graph_ms(torch, lambda: kq.int8_conv_cuda(
            xq, wq, xs, ks, stride, p, bf16))
        plain_ms = time_ms(torch, lambda: tq.qconv_plain(
            xq, wq, xs, ks, stride, p), iters=2, warmup=1)
        xb = x.permute(0, 3, 1, 2)
        wb = w.to(bf16).contiguous(memory_format=torch.channels_last)
        lib_ms = graph_ms(torch, lambda: F.conv2d(xb, wb, stride=stride,
                                                  padding=p))
        outs = n * ho * wo * co
        b_ms, b_by = bound(xq.numel() + wq.numel() + 2 * outs + 8,
                           2 * outs * ci * k * k, INT8_OPS)
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms",
                       lib_ms), ("bound_ms", b_ms), (b_by, b_ms)):
            tot[key] = tot.get(key, 0.0) + v
        if i in named:
            case = dict(case=named[i], ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            case["ms_f32"] = graph_ms(torch, lambda: kq.int8_conv_cuda(
                xq, wq, xs, ks, stride, p, torch.float32))
            case["bound_ms_f32"], _ = bound(
                xq.numel() + wq.numel() + 4 * outs + 8,
                2 * outs * ci * k * k, INT8_OPS)
            cases.append(case)
            print(f"[K2s int8_conv {named[i]}] {tuple(x.shape)} -> "
                  f"{(n, ho, wo, co)}, {k}x{k} stride {stride}: identical "
                  f"to the plain version in bf16 and f32; {ms:.4f} ms bf16 "
                  f"(bound {b_ms:.4f}), {case['ms_f32']:.4f} ms f32 (bound "
                  f"{case['bound_ms_f32']:.4f}), plain {plain_ms:.3f} ms, "
                  f"cuDNN bf16 {lib_ms:.4f} ms ({b_by})")
        del x, xq, xb, wb
    torch.cuda.empty_cache()
    print(f"[K2s int8_conv] the 45 backbone convs of one collection call, "
          f"each identical to the plain version in bf16 and f32: "
          f"{tot['ms']:.3f} ms in bf16, cuDNN bf16 {tot['library_ms']:.3f} "
          f"ms, plain "
          f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms")
    return dict(name="int8_conv", route="cuda",
                source="coin_tpu_torch/csrc/qconv.cu",
                replaces="coin_tpu/models/clip_resnet.py:62",
                max_abs_err=0.0, ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=tot["bound_ms"],
                bound_by=max(("bytes", "operations"),
                             key=lambda by: tot.get(by, 0.0)),
                library_ms=tot["library_ms"], convs=len(shapes),
                cases=cases)


# -------------------------------------------------------- reference phase
def phase_reference(torch, dev, cfg, num_classes, tokens):
    """The f32 detector on the card (kernels) against the same weights on
    the CPU (plain versions) at a 128 x 256 canvas."""
    import dataclasses
    from coin_tpu_torch.data.augment import normalize_batch
    from coin_tpu_torch.device import parity_numerics
    from coin_tpu_torch.engine import pipelines
    parity_numerics()
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    pcfg = dataclasses.replace(pipelines.pipeline_config_from(cfg32,
                                                              num_classes),
                               pre_nms_topk_test=600, post_nms_topk_test=100)
    gpu = pipelines.build_detector(cfg32, num_classes, dev).random_init(SEED)
    cpu = pipelines.build_detector(cfg32, num_classes, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    gen = torch.Generator().manual_seed(SEED + 1)
    cells = torch.randint(0, 256, (2, 8, 16, 3), generator=gen,
                          dtype=torch.uint8)
    images_u8 = cells.repeat_interleave(16, 1).repeat_interleave(16, 2)
    hw = torch.tensor([[128.0, 256.0], [128.0, 200.0]])
    out = {}
    with torch.inference_mode():
        for name, model, d in (("gpu", gpu, dev), ("cpu", cpu, "cpu")):
            images = normalize_batch(images_u8.to(d))
            feats = model.features(images)
            obj, deltas = model.rpn(feats)
            out[name] = (images, feats, obj, deltas)
        # identical proposals on both sides for the pooled features
        anchors = pipelines.anchors_for(out["cpu"][0], pcfg)
        from coin_tpu_torch.models.rpn import predict_proposals
        props = {n: predict_proposals(anchors.to(d), out["cpu"][2].to(d),
                                      out["cpu"][3].to(d), hw.to(d), 600,
                                      100, pcfg.rpn_nms_thresh)
                 for n, d in (("gpu", dev), ("cpu", "cpu"))}
        pooled = {n: m.pool_boxes(out["cpu"][1].to(d),
                                  props["cpu"].boxes.to(d))
                  for n, m, d in (("gpu", gpu, dev), ("cpu", cpu, "cpu"))}
    errs = {}
    for key, i in (("images", 0), ("res4", 1), ("objectness", 2),
                   ("rpn_deltas", 3)):
        a, b = out["gpu"][i].cpu(), out["cpu"][i]
        errs[key] = ((a - b).abs().max() / b.abs().max()).item()
    errs["pooled"] = ((pooled["gpu"].cpu() - pooled["cpu"]).abs().max()
                      / pooled["cpu"].abs().max()).item()
    same_keep = torch.equal(props["gpu"].valid.cpu(), props["cpu"].valid)
    box_err = (props["gpu"].boxes.cpu() - props["cpu"].boxes).abs().max()
    print(f"[reference] f32 card vs CPU, full-width RN50 at 2x128x256: "
          f"relative max errors {json.dumps(errs)} (tol 1e-3); "
          f"proposal keep masks identical: {same_keep}, box err "
          f"{box_err.item():.3g}")
    check(all(v <= 1e-3 for v in errs.values()), f"reference: {errs}")
    check(same_keep and box_err.item() <= 1e-3,
          "reference: proposals differ")
    del gpu, cpu
    torch.cuda.empty_cache()


def to_dev(d, dev):
    return d.map(lambda t: t.to(dev))


def phase_step_reference(torch, dev, num_classes, tokens, int8=False,
                         int8_roi=False):
    """train_step_cached, then train_step (burn-up at step 1: EMA + the
    live teacher), of the full-width f32 model on the card (kernels)
    against the CPU (plain versions): same weights, same injected draws,
    2 x 128 x 256. The teacher's score threshold is above 1 here, so it
    keeps no detection: near-tied random-init class scores would otherwise
    order its detections differently on the two devices. ``int8``: one
    train_step_cached with foggy_fast.yaml's int8 res5 (qt = 1: the K2
    forward, dgrad and wgrad on the card, their plain versions on the
    CPU); with ``int8_roi`` the int8train_ps_roi configuration instead
    (qt = 3 and the int8 RoIAlign: K2 forward and dgrad with per-sample
    scales, K5 and K5b)."""
    import dataclasses
    from coin_tpu_torch.config import load_config
    from coin_tpu_torch.device import parity_numerics
    from coin_tpu_torch.engine import pipelines
    from coin_tpu_torch.engine import step_builder as sb
    from coin_tpu_torch.engine.common import synthetic_detections
    parity_numerics()
    qt = (3 if int8_roi else 1) if int8 else 0
    cfg = load_config(os.path.join(REPO, "configs/coin/GDINO/foggy.yaml"))
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.TPU.INT8_TRAIN = int8
    if int8_roi:
        # the int8train_ps_roi arm (tools/validate_cached_teacher.py:243)
        cfg.TPU.INT8_TRAIN_WGRAD = False
        cfg.TPU.INT8_TRAIN_SCALE = "sample"
        cfg.TPU.INT8_ROI = True
    pcfg = dataclasses.replace(
        pipelines.pipeline_config_from(cfg, num_classes),
        pre_nms_topk_train=600, post_nms_topk_train=100,
        pre_nms_topk_test=600, post_nms_topk_test=100, roi_batch_size=64)
    teacher_pcfg = dataclasses.replace(pcfg, test_score_thresh=1.5)
    hyper = dataclasses.replace(
        sb.hyper_from_cfg(cfg), burn_up=1, proto_start=0, cap_c=16,
        loss_weights=pipelines.loss_weights_from(cfg))
    gen = torch.Generator().manual_seed(SEED + 2)
    cells = torch.randint(0, 256, (2, 8, 16, 3), generator=gen,
                          dtype=torch.uint8)
    images = cells.repeat_interleave(16, 1).repeat_interleave(16, 2)
    hw = torch.tensor([[128.0, 256.0], [128.0, 200.0]])
    online = [synthetic_detections(gen, 2, 16, num_classes, (128, 200),
                                   [9, 6]) for _ in range(2)]
    offline = synthetic_detections(gen, 2, 24, num_classes, (128, 200),
                                   [12, 16])
    offline = offline.replace(boxes=torch.cat(
        [online[0].boxes[:, :8] + 1.0, offline.boxes[:, 8:]], 1))
    anchors = 8 * 16 * 15
    draws = [sb.draw_step(gen, 2, anchors, sb.num_candidates(pcfg, 16, n))
             for n in (24, teacher_pcfg.test_topk)]

    tok = {d: torch.as_tensor(tokens, device=d).long() for d in (dev, "cpu")}
    states, losses = {}, {}
    for d in (dev, "cpu"):
        model = pipelines.build_detector(cfg, num_classes, d)
        if d == dev:
            model.random_init(SEED)
        else:
            model.load_state_dict(states[dev].model.state_dict())
        states[d] = sb.init_train_state(cfg, model, tok[d], SEED)
    # the same starting prototypes on both sides, off the text features:
    # at them the L1 text-align loss sits at its kink, where its gradient
    # is the sign of rounding noise
    protos = type(states["cpu"].prototypes)(
        *(p + 0.05 * torch.randn(p.shape, generator=gen)
          for p in dataclasses.astuple(states["cpu"].prototypes)))
    states["cpu"].prototypes = protos
    states[dev].prototypes = type(protos)(
        *(p.to(dev) for p in dataclasses.astuple(protos)))
    before = {n: p.detach().cpu().clone()
              for n, p in states["cpu"].model.named_parameters()}
    flipped = None
    if int8:
        # the share of res5's first s8 activations that round differently
        # on the card and on the CPU: same weights, images and boxes
        from coin_tpu_torch.data.augment import normalize_batch
        from coin_tpu_torch.ops.qconv import quantize
        from coin_tpu_torch.ops.roi_align import (roi_align_batched,
                                                  roi_align_int8_batched)
        ra = roi_align_int8_batched if int8_roi else roi_align_batched
        q = {}
        with torch.inference_mode():
            for d in (dev, "cpu"):
                feats = states[d].model.features(normalize_batch(images.to(d)))
                crops = ra(feats, online[0].boxes.to(d), 1.0 / 16.0, 14,
                           2).flatten(0, 1)
                q[d] = quantize(crops.contiguous(), int8_roi)[0].cpu()
        flipped = (q[dev] != q["cpu"]).float().mean().item()
    merge_before = {n: p.detach().clone() for n, p in
                    states["cpu"].merge_model.named_parameters()}
    for d in (dev, "cpu"):
        live, cached, _ = sb.build_adaptation_steps(tok[d], pcfg,
                                                    teacher_pcfg, hyper)
        dd = lambda x: to_dev(x, d)
        move = lambda s: sb.StepDraws(*(t.to(d) for t in
                                        dataclasses.astuple(s)))
        st, l1 = cached(states[d], images.to(d), hw.to(d), dd(online[0]),
                        dd(online[1]), dd(offline), draws=move(draws[0]))
        losses[d] = {"cached/" + k: v.item() for k, v in l1.items()}
        if not int8:
            st, l2 = live(st, images.to(d), hw.to(d), dd(online[0]),
                          dd(online[1]), draws=move(draws[1]))
            losses[d].update({"live/" + k: v.item() for k, v in l2.items()})
    gpu, cpu = states[dev], states["cpu"]

    def rel(a, b, base=None):
        """||a - b|| / ||b|| per tensor; an update (new - ``base``) less
        the f32 rounding of the parameters it moved."""
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        norm = torch.linalg.vector_norm
        slack = 0.0 if base is None else \
            2 * torch.finfo(torch.float32).eps * norm(base.double()).item()
        return max(norm(a - b).item() - slack, 0.0) / max(norm(b).item(),
                                                           1e-30)

    errs = {"losses": max(abs(losses[dev][k] - v) / max(abs(v), 1e-3)
                          for k, v in losses["cpu"].items())}
    gp = dict(gpu.model.named_parameters())
    gt = dict(gpu.teacher.named_parameters())
    ct = dict(cpu.teacher.named_parameters())
    gm = gpu.optimizer.momentum_buffers()
    cm = cpu.optimizer.momentum_buffers()
    errs["params"] = max(rel(gp[n] - before[n].to(dev), p - before[n],
                             before[n])
                         for n, p in cpu.model.named_parameters()
                         if p.requires_grad)
    errs["momentum"] = max(rel(gm[n], cm[n]) for n in cm)
    errs["teacher"] = max(rel(gt[n] - before[n].to(dev), ct[n] - before[n],
                              before[n]) for n in ct)
    errs["prototypes"] = max(rel(getattr(gpu.prototypes, f),
                                 getattr(cpu.prototypes, f))
                             for f in ("proto", "b_online", "b_offline"))
    gmm = dict(gpu.merge_model.named_parameters())
    errs["merge"] = max(rel(gmm[n] - merge_before[n].to(dev),
                            p - merge_before[n], merge_before[n])
                        for n, p in cpu.merge_model.named_parameters())
    if int8:
        # an s8 value that rounds the other way moves a whole quantisation
        # step; res5's dgrad and the second-order merge gradient carry the
        # flips on (the CPU tests hold JAX's int8 step to the same bounds)
        tol, base = {"merge": 0.15}, 2e-2
        what = (f"train_step_cached with the int8 res5 (qt {qt}"
                f"{', the int8 RoIAlign' if int8_roi else ''}; s8 values of "
                f"res5's input that differ: {flipped:.3g})")
        why = ("tol 2e-2, merge 0.15: each flipped s8 value moves a whole "
               "quantisation step")
    else:
        tol, base = {"merge": 1e-2}, 1e-3
        what = "train_step_cached then train_step"
        why = ("tol 1e-3; merge 1e-2: its second-order gradient keeps "
               "about three digits in f32")
    print(f"[step reference] full-width f32, card vs CPU, 2 x 128 x 256, "
          f"{what}: largest relative errors "
          f"(losses |card - CPU| / max(|CPU|, 1e-3); tensors ||card - "
          f"CPU|| / ||CPU|| of the momentum, the parameter, teacher and "
          f"merge updates, the prototypes) {json.dumps(errs)} ({why}); "
          f"losses "
          f"{json.dumps({k: round(v, 6) for k, v in losses['cpu'].items()})}")
    check(all(v <= tol.get(k, base) for k, v in errs.items()),
          f"step reference: {errs}")
    check(flipped is None or flipped <= 1e-2,
          f"step reference: {flipped} of res5's s8 inputs differ")
    check(gpu.step == cpu.step == (1 if int8 else 2)
          and losses["cpu"]["cached/loss_cls"] > 0,
          "step reference: steps not taken")
    check(all(m.qt == qt for m in gpu.model.res5.modules()
              if hasattr(m, "qt")) and gpu.model.quant_roi == int8_roi,
          "step reference: res5 int8 mode or the int8 RoIAlign")
    del states, gpu, cpu
    torch.cuda.empty_cache()


# --------------------------------------------------------------- main path
def phase_main_path(torch, dev, cfg, num_classes, tokens, counters):
    from coin_tpu_torch.data.augment import normalize_batch
    from coin_tpu_torch.data.loader import TestLoader
    from coin_tpu_torch.data.voc import (CITYSCAPES_CLASSES,
                                         make_synthetic_voc,
                                         register_pascal_voc)
    from coin_tpu_torch.engine import pipelines
    from coin_tpu_torch.engine.evaluator import evaluate_detector
    from coin_tpu_torch.ops.roi_align import roi_align_batched

    root = os.path.join(REPO, "output", "chip_smoke")
    shutil.rmtree(root, ignore_errors=True)
    try:
        make_synthetic_voc(os.path.join(root, "foggy"), num_images=8,
                           class_names=CITYSCAPES_CLASSES,
                           image_hw=(1024, 2048), seed=SEED, split="val")
        register_pascal_voc("chip_smoke_foggyval", "foggy", "val",
                            CITYSCAPES_CLASSES, ".jpg")
        loader = TestLoader(
            "chip_smoke_foggyval", root,
            batch_size=max(cfg.SOLVER.IMG_PER_BATCH_UNLABEL, 4),
            min_size=cfg.INPUT.MIN_SIZE_TEST, max_size=cfg.INPUT.MAX_SIZE)
        check(tuple(loader.canvas_hw) == tuple(cfg.TPU.IMAGE_HW) == (608, 1216)
              and loader.batch_size == 4, f"canvas {loader.canvas_hw}")
        pcfg = pipelines.pipeline_config_from(cfg, num_classes)
        check((pcfg.pre_nms_topk_test, pcfg.post_nms_topk_test,
               pcfg.test_topk) == (6000, 1000, 100), f"{pcfg}")
        model = pipelines.build_detector(cfg, num_classes, dev)
        model.random_init(SEED)
        check(model.compute_dtype == torch.bfloat16
              and all(p.dtype == torch.float32 for p in model.parameters())
              and model.text_trunk.layers == 12
              and model.text_trunk.ln_final.normalized_shape == (512,),
              "not the full-width RN50 detector with f32 master weights "
              "computing in bf16")
        params = model.state_dict()

        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = evaluate_detector(model, params, loader, tokens, pcfg)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        print(f"[main path] evaluate_detector over {len(loader.records)} "
              f"images in {len(loader)} batches of 4: {eval_s:.3f} s "
              f"(host decode included); AP {results['AP']:.4f} AP50 "
              f"{results['AP50']:.4f} AP75 {results['AP75']:.4f}; kernel "
              f"launches {json.dumps(launches)}")
        check(all(v > 0 for v in launches.values()),
              f"a kernel was not launched on the main path: {launches}")
        check(all(0.0 <= results[k] <= 100.0 for k in ("AP", "AP50", "AP75")),
              f"AP out of range: {results}")

        # device latency of one batch, the same call evaluate_detector makes
        batch, _ = next(iter(loader))
        images_u8 = torch.from_numpy(batch.images).to(dev)
        image_hw = torch.from_numpy(batch.image_hw).to(dev)
        tok = torch.as_tensor(tokens, device=dev)
        with torch.inference_mode():
            text = model.text_features(tok)

            def infer():
                return pipelines.inference(model, normalize_batch(images_u8),
                                           image_hw, tok, pcfg,
                                           text_features=text)
            dets = infer()
            ms = time_ms(torch, infer, iters=5, warmup=1)
            # the same batch stage by stage, each stage timed on its own
            images = normalize_batch(images_u8)
            feats = model.features(images)
            anchors = pipelines.anchors_for(images, pcfg)
            _, _, props = pipelines.rpn_forward(model, feats, image_hw,
                                                anchors, pcfg)
            pooled = model.pool_boxes(feats, props.boxes,
                                      pcfg.pooler_resolution)
            crops = roi_align_batched(feats, props.boxes, 1.0 / 16.0,
                                      pcfg.pooler_resolution, 2).flatten(0, 1)
            stages = {
                "normalize": lambda: normalize_batch(images_u8),
                "backbone": lambda: model.features(images),
                "rpn_and_proposals": lambda: pipelines.rpn_forward(
                    model, feats, image_hw, anchors, pcfg),
                "roi_align_res5_pool": lambda: model.pool_boxes(
                    feats, props.boxes, pcfg.pooler_resolution),
                "of_which_res5": lambda: model.res5(crops),
                "predict_and_box_inference": lambda: pipelines.box_inference(
                    model, pooled, props, image_hw, text, pcfg),
            }
            stage_ms = {k: time_ms(torch, f, iters=5, warmup=1)
                        for k, f in stages.items()}
        v = dets.valid
        check(dets.boxes.shape == (4, 100, 4) and int(v.sum()) > 0,
              f"detections {tuple(dets.boxes.shape)}, {int(v.sum())} valid")
        check(bool(torch.isfinite(dets.boxes[v]).all()
                   and torch.isfinite(dets.scores[v]).all()),
              "non-finite boxes or scores")
        check(bool(((dets.scores[v] > 0.05) & (dets.scores[v] <= 1)).all()),
              "scores outside (0.05, 1]")
        print(f"[main path] inference of one batch (4 x 608 x 1216, bf16): "
              f"{ms:.3f} ms per batch, {4000.0 / ms:.2f} images/s; "
              f"{int(v.sum())} detections, all finite")
        print(f"[main path] stages of that batch, ms each: "
              f"{json.dumps(stage_ms)}")
        return launches, ms
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _snapshot(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def _moved(module, before):
    """Names of the parameters that changed since ``before``."""
    return [n for n, p in module.named_parameters()
            if not bool((p.detach() == before[n]).all())]


def phase_train_path(torch, dev, num_classes, tokens, counters):
    """build_adaptation_steps at full width from foggy.yaml: N cached
    steps on the teacher's own predictions, then live and cached_two
    steps past a burn-up moved to step N. The optimizers start past
    warmup (count 400, lr 0.001) and prototype updates from step 0, so
    that a few steps move every state the step owns."""
    import dataclasses
    from coin_tpu_torch.config import load_config
    from coin_tpu_torch.data.augment import normalize_batch
    from coin_tpu_torch.engine import pipelines
    from coin_tpu_torch.engine import step_builder as sb
    from coin_tpu_torch.engine.common import synthetic_detections
    cfg = load_config(os.path.join(REPO, "configs/coin/GDINO/foggy.yaml"))
    pcfg = pipelines.pipeline_config_from(cfg, num_classes)
    batch = cfg.SOLVER.IMG_PER_BATCH_UNLABEL
    hh, ww = cfg.TPU.IMAGE_HW
    cap = cfg.TPU.CAP_TEACHER
    check((batch, hh, ww, cap, cfg.TPU.CAP_C, pcfg.pre_nms_topk_train,
           pcfg.post_nms_topk_train, pcfg.roi_batch_size,
           cfg.get_path("TPU.INT8_TRAIN", False))
          == (3, 608, 1216, 128, 64, 6000, 1000, 512, False),
          "not the foggy.yaml training shapes")
    n_cached, n_live, n_two = 3, 3, 2
    hyper = dataclasses.replace(
        sb.hyper_from_cfg(cfg), burn_up=n_cached, proto_start=0,
        loss_weights=pipelines.loss_weights_from(cfg))
    model = pipelines.build_detector(cfg, num_classes, dev).random_init(SEED)
    check(model.compute_dtype == torch.bfloat16
          and all(p.dtype == torch.float32 for p in model.parameters()),
          "training model: f32 master weights, bf16 compute expected")
    tok = torch.as_tensor(tokens, device=dev).long()
    state = sb.init_train_state(cfg, model, tok, SEED)
    state.optimizer.count = state.merge_optimizer.count = \
        cfg.SOLVER.WARMUP_ITERS
    live, cached, cached_two = sb.build_adaptation_steps(tok, pcfg, pcfg,
                                                         hyper)
    gen = torch.Generator().manual_seed(SEED + 3)
    cells = torch.randint(0, 256, (batch, hh // 16, ww // 16, 3),
                          generator=gen, dtype=torch.uint8)
    noise = torch.randint(0, 32, (batch, hh, ww, 3), generator=gen,
                          dtype=torch.uint8)
    images = (cells.repeat_interleave(16, 1).repeat_interleave(16, 2) // 2
              + noise).to(dev)
    hw = torch.tensor([[hh, ww], [hh, 1100.0], [560.0, ww]], device=dev)
    n_valid = [48, 31, 60]
    online_rcnn = to_dev(synthetic_detections(gen, batch, cap, num_classes,
                                              (hh, ww), n_valid), dev)
    online_rpn = to_dev(synthetic_detections(
        gen, batch, cap, num_classes, (hh, ww), [n + 9 for n in n_valid]),
        dev)

    def offline_now():
        with torch.inference_mode():
            return pipelines.inference(state.teacher, normalize_batch(images),
                                       hw, tok, pcfg)

    # part of the cloud's boxes agree with the teacher's top detections,
    # half of those in class, so that A and B pairs form from step 0
    first = offline_now()
    k = min(24, first.capacity, cap)
    near = first.boxes[:, :k] + (torch.rand((batch, k, 4), generator=gen)
                                 * 4 - 2).to(dev)
    cls = first.classes[:, :k].clamp_min(0)
    cls = torch.where(torch.arange(k, device=dev) < k // 2, cls,
                      (cls + 1) % num_classes)
    probs = 0.05 + 0.75 * torch.nn.functional.one_hot(
        cls.long(), num_classes + 1).float()
    online_rcnn = online_rcnn.replace(
        boxes=torch.cat([near, online_rcnn.boxes[:, k:]], 1),
        classes=torch.cat([cls.int(), online_rcnn.classes[:, k:]], 1),
        probs=torch.cat([probs / probs.sum(-1, keepdim=True),
                         online_rcnn.probs[:, k:]], 1))
    online_rcnn = online_rcnn.replace(
        scores=online_rcnn.probs[..., :-1].amax(-1))
    online_rpn = online_rpn.replace(boxes=torch.cat(
        [first.boxes[:, :k // 2], online_rpn.boxes[:, k // 2:]], 1))

    before = {"student": _snapshot(state.model),
              "teacher": _snapshot(state.teacher),
              "merge": _snapshot(state.merge_model)}
    proto_before = state.prototypes.proto.clone()
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    all_losses = []
    for i in range(n_cached + n_live + n_two):
        if i < n_cached:
            state, losses = cached(state, images, hw, online_rcnn,
                                   online_rpn, offline_now())
        elif i < n_cached + n_live:
            state, losses = live(state, images, hw, online_rcnn, online_rpn)
        else:
            state, losses = cached_two(state, images, hw, online_rcnn,
                                       online_rpn, offline_now())
        all_losses.append({k: v.item() for k, v in losses.items()})
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"[training path] {n_cached} train_step_cached (offline from the "
          f"teacher's inference on the weak view), {n_live} train_step, "
          f"{n_two} train_step_cached_two; batch {batch} x {hh} x {ww}, "
          f"bf16, {pcfg.roi_batch_size} + {hyper.cap_c} RoIs per image: "
          f"{run_s:.3f} s; kernel launches {json.dumps(launches)}")
    for i, l in enumerate(all_losses):
        print(f"  step {i}: " + json.dumps({k: round(v, 5)
                                            for k, v in l.items()}))
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the training path: {launches}")
    check(all(math.isfinite(v) for l in all_losses for v in l.values()),
          "a loss is not finite")
    check(state.step == n_cached + n_live + n_two, "steps not counted")
    moved = {k: len(_moved(m, before[k])) for k, m in
             (("student", state.model), ("teacher", state.teacher),
              ("merge", state.merge_model))}
    n_train = len([p for p in state.model.parameters() if p.requires_grad])
    print(f"[training path] parameter tensors that moved: {moved} (of "
          f"{n_train} trainable, {len(before['merge'])} merge); prototypes "
          f"moved by {(state.prototypes.proto - proto_before).abs().max().item():.3g}")
    check(moved["student"] > 0 and moved["teacher"] > 0
          and moved["merge"] > 0, f"state did not move: {moved}")
    check(bool((state.prototypes.proto != proto_before).any()),
          "prototypes did not move")

    # ms per step of each flavor, and the cached step by stage
    offline = offline_now()
    flavors = {
        "train_step_cached": lambda: cached(state, images, hw, online_rcnn,
                                            online_rpn, offline),
        "train_step": lambda: live(state, images, hw, online_rcnn,
                                   online_rpn),
        "train_step_cached_two": lambda: cached_two(
            state, images, hw, online_rcnn, online_rpn, offline),
    }
    step_ms = {}
    for name, fn in flavors.items():
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms[name] = statistics.median(times)
    # the cached step again, with a CUDA event at the end of each stage
    marks = []

    def on_stage(name):
        marks.append((name, torch.cuda.Event(enable_timing=True)))
        marks[-1][1].record()
    _, timed, _ = sb.build_adaptation_steps(tok, pcfg, pcfg, hyper,
                                            on_stage=on_stage)
    stages = []
    for _ in range(3):
        marks.clear()
        on_stage("start")
        timed(state, images, hw, online_rcnn, online_rpn, offline)
        torch.cuda.synchronize()
        stages.append({name: marks[i][1].elapsed_time(e)
                       for i, (name, e) in enumerate(marks[1:])})
    stage_ms = {k: statistics.median(s[k] for s in stages)
                for k in stages[0]}
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[training path] ms per step (median of 3, host clock to a "
          f"synchronize): {json.dumps(step_ms)}; images/s of the cached step "
          f"{batch * 1000.0 / step_ms['train_step_cached']:.2f}; peak "
          f"device memory {mem:.1f} GiB")
    print(f"[training path] cached step by stage, ms (median of 3, CUDA "
          f"events at build_adaptation_steps' stage marks; student_forward "
          f"includes matching): {json.dumps(stage_ms)}")
    return launches, step_ms


def _cloud_store(torch, store, teacher, loader, num_classes, seed):
    """A synthetic cloud store in original image coordinates: for each
    image, the first 24 of the teacher's own detections (canvas
    coordinates) moved by up to 2 pixels (half of them in another class, so
    that A and B pairs form with the teacher) and 24 random boxes; the RPN
    view shares the first 12."""
    import numpy as np
    from coin_tpu_torch.data.loader import _resize_factor
    rng = np.random.RandomState(seed)
    for rec in loader.records:
        image_id, h, w = rec["image_id"], rec["height"], rec["width"]
        near = teacher.get_view(image_id, "RCNN")
        k = min(24, len(near["boxes"]))
        scale = _resize_factor(h, w, loader.min_size, loader.max_size)
        boxes = near["boxes"][:k] / scale + rng.uniform(-2, 2, (k, 4))
        cls = near["classes"][:k].copy()
        cls[k // 2:] = (cls[k // 2:] + 1) % num_classes
        xy = rng.uniform(0, 1, (24, 2)) * (w, h)
        extra = np.concatenate([xy, xy + rng.uniform(16, 300, (24, 2))], 1)
        boxes = np.concatenate([boxes, extra]).astype(np.float32)
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
        cls = np.concatenate([cls, rng.randint(0, num_classes, 24)])
        probs = np.full((len(cls), num_classes + 1), 0.05, np.float32)
        probs[np.arange(len(cls)), cls] = 0.8
        probs /= probs.sum(1, keepdims=True)
        scores = probs[:, :-1].max(1)
        store.put(image_id, "RCNN", boxes, cls, scores, probs)
        store.put(image_id, "RPN", boxes[:12], cls[:12], scores[:12],
                  probs[:12])
    return store


def _share_crops_pass(torch, tr, cfg):
    """The collection pass of foggy_fast.yaml with TPU.TEACHER_SHARE_CROPS
    512 (the teacher's budget) from the trained teacher of ``tr``: after
    the RPN's NMS at 0.7 no two proposals reach IoU 0.9, so every cluster
    is a singleton and the store must equal the pass without the knob bit
    for bit. Returns K11's launches in the pass and ms per image of both
    passes."""
    from coin_tpu_torch.engine.trainer import CoinTrainer
    from coin_tpu_torch.kernels.dedup import self_cluster_cuda
    scfg = cfg.clone()
    scfg.TPU["TEACHER_SHARE_CROPS"] = 512
    share = CoinTrainer(scfg)
    check(share.teacher_pcfg.share_crops_budget == 512
          and share.teacher_pcfg.share_crops_thresh == 0.9
          and tr.teacher_pcfg.share_crops_budget == 0,
          "share crops: the teacher's pipeline config")
    share.state.teacher = tr.state.teacher
    share._collect_loader = tr._collect_loader
    ms = {}
    for name, t in (("plain", tr), ("shared", share), ("plain", tr),
                    ("shared", share)):
        t.cfg.TPU.INT8_COLLECT = True
        self_cluster_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store = CoinTrainer.collect_teacher_store(t)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3 / 12
        if name == "plain":
            plain = store
            check(self_cluster_cuda.launches == 0, "share crops: K11 ran "
                  "in the pass without the knob")
        else:
            launches = self_cluster_cuda.launches
    check(launches == 6, f"share crops: K11 launched {launches} times, "
          f"want 6 (3 batches x 2 orientations)")
    rows = 0
    check(sorted(store.image_ids()) == sorted(plain.image_ids()),
          "share crops: image ids")
    for image_id in plain.image_ids():
        for view in ("RCNN", "RCNN_FLIP"):
            a, b = store.get_view(image_id, view), plain.get_view(image_id,
                                                                  view)
            check(set(a) == set(b) and all(
                a[k].shape == b[k].shape and (a[k] == b[k]).all()
                for k in b), f"share crops: {image_id}/{view} differs")
            rows += len(b["boxes"])
    print(f"[share crops] foggy_fast.yaml with TPU.TEACHER_SHARE_CROPS 512: "
          f"the store equals the pass without it bit for bit ({rows} rows "
          f"over 12 images x 2 orientations); K11 launched {launches} times; "
          f"ms per image with the host decode: {json.dumps(ms)}")
    return {"self_cluster_cuda": launches}, ms


def _rounded(times):
    """{name: [ms, ...]} as JSON, to the microsecond."""
    return json.dumps({k: [round(t, 3) for t in v] for k, v in times.items()})


def _int8_ps_cfg(root, npz, int8_roi):
    """foggy_fast.yaml with the int8train_ps overrides of the reference's
    A/B harness (tools/validate_cached_teacher.py:238-248), with or without
    TPU.INT8_ROI, on the synthetic set under ``root``."""
    from coin_tpu_torch.config import load_config
    cfg = load_config(os.path.join(REPO, "configs/coin/GDINO/foggy_fast.yaml"))
    cfg.DATASETS.ROOT = root
    cfg.DATASETS.TRAIN_UNLABEL = ["chip_smoke_roitrain"]
    cfg.DATASETS.TEST = ["chip_smoke_roival"]
    cfg.OUTPUT_DIR = os.path.join(root, "run_roi" if int8_roi else "run_ps")
    cfg.CLOUD.COLLECT_FILE = npz
    cfg.CLOUD.BURN_UP_STEP = 4
    cfg.TPU.CACHE_TEACHER_MIN_STEPS = 0
    cfg.CLOUD.PROTOTYPE_UPDATE_START = 0
    cfg.TEST.EVAL_PERIOD = 8
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 ** 9
    cfg.TPU.INT8_TRAIN = True
    cfg.TPU.INT8_TRAIN_WGRAD = False
    cfg.TPU.INT8_TRAIN_SCALE = "sample"
    if int8_roi:
        cfg.TPU.INT8_ROI = True
    return cfg


def phase_int8_roi_trainer_path(torch, dev, num_classes, counters):
    """CoinTrainer.train of the int8train_ps_roi configuration (foggy_fast
    .yaml, per-sample int8 res5 without the int8 wgrad, the int8 RoIAlign)
    at full width, 8 steps as the trainer path runs them; this slice's main
    path. Then the same 8 steps of int8train_ps (INT8_ROI off) and their
    cached steps in turns with the int8-RoI ones, on one card. Returns the
    launches of every kernel in the int8-RoI run and its measurements."""
    from coin_tpu_torch.data.voc import (CITYSCAPES_CLASSES,
                                         make_synthetic_voc,
                                         register_pascal_voc)
    from coin_tpu_torch.engine.pipelines import int8_train_mode
    from coin_tpu_torch.engine.pre_train import online_view_to_detections
    from coin_tpu_torch.engine.results_store import ResultStore
    from coin_tpu_torch.engine.trainer import CoinTrainer
    from coin_tpu_torch.kernels.roi_align import (roi_align_backward_cuda,
                                                  roi_align_cuda)

    root = os.path.join(REPO, "output", "chip_smoke_int8_roi")
    shutil.rmtree(root, ignore_errors=True)
    try:
        voc = os.path.join(root, "foggy")
        make_synthetic_voc(voc, num_images=12, class_names=CITYSCAPES_CLASSES,
                           image_hw=(1024, 2048), seed=SEED, split="train")
        make_synthetic_voc(voc, num_images=4, class_names=CITYSCAPES_CLASSES,
                           image_hw=(1024, 2048), seed=SEED + 1, split="val")
        register_pascal_voc("chip_smoke_roitrain", "foggy", "train",
                            CITYSCAPES_CLASSES, ".jpg")
        register_pascal_voc("chip_smoke_roival", "foggy", "val",
                            CITYSCAPES_CLASSES, ".jpg")
        npz = os.path.join(root, "GDINO_collect.npz")
        ResultStore(num_classes).save(npz)
        runs, raw = {}, {}
        for name, int8_roi in (("int8_ps_roi", True), ("int8_ps", False)):
            cfg = _int8_ps_cfg(root, npz, int8_roi)
            check(int8_train_mode(cfg) == 3, "not the int8train_ps mode")
            tr = CoinTrainer(cfg)
            m = tr.model
            check(m.quant_train_res5 == 3 and m.quant_roi == int8_roi
                  and m.clone(quant_convs=True).quant_roi == int8_roi
                  and m.compute_dtype == torch.bfloat16
                  and m.text_trunk.layers == 12
                  and tr.teacher_pcfg.post_nms_topk_test == 512
                  and tr.pcfg.roi_batch_size == 512
                  and tr.cfg.SOLVER.IMG_PER_BATCH_UNLABEL == 3,
                  f"{name}: not the full-width detector of its arm")
            if int8_roi:
                # the cloud store, paired with the teacher's detections
                teacher_store = tr.collect_teacher_store()
                _cloud_store(torch, ResultStore(num_classes), teacher_store,
                             tr.train_loader, num_classes, SEED).save(npz)
            tr.store = tr.train_loader.store = ResultStore.load(npz)
            raw[name] = (tr, tr._train_step_cached)
            seq, times, all_losses = [], {}, []

            def timed(label, fn):
                def run(*args, **kw):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = fn(*args, **kw)
                    torch.cuda.synchronize()
                    times.setdefault(label, []).append(
                        (time.perf_counter() - t) * 1e3)
                    seq.append(label)
                    if label.startswith("train_step"):
                        all_losses.append({k: v.item()
                                           for k, v in out[1].items()})
                    return out
                return run
            for attr in ("_train_step_cached", "_train_step_cached_two",
                         "collect_teacher_store", "test", "test_teacher"):
                setattr(tr, attr, timed(attr.lstrip("_"), getattr(tr, attr)))
            tr.teacher_store = None
            before = _snapshot(tr.state.model)
            for fn in counters:
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = tr.train(max_iter=8)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counters}
            want = (["collect_teacher_store"] + ["train_step_cached"] * 4
                    + ["collect_teacher_store"]
                    + ["train_step_cached_two"] * 4 + ["test", "test_teacher"])
            check(seq == want, f"{name}: sequence {seq}")
            check(all(math.isfinite(v) for l in all_losses
                      for v in l.values()), f"{name}: a loss is not finite")
            check(state.step == 8 and _moved(state.model, before),
                  f"{name}: the student did not train")
            aps = (tr.ap_50_student.get(7), tr.ap_50_offline_teacher.get(7))
            check(all(a is not None and 0.0 <= a <= 100.0 for a in aps),
                  f"{name}: eval AP50 {aps}")
            step_ms = {k: statistics.median(v[1:] or v)
                       for k, v in times.items() if k.startswith("train")}
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            runs[name] = dict(step_ms=step_ms, launches=launches,
                              peak_gib=mem, run_s=run_s)
            print(f"[int8 RoI path] {name}: train(max_iter=8) {run_s:.3f} s; "
                  f"ms per step (host clock to a synchronize; median after "
                  f"the first of each flavor) {json.dumps(step_ms)}, all "
                  f"{_rounded(times)}; peak {mem:.1f} GiB; AP50 student "
                  f"{aps[0]:.4f}, teacher {aps[1]:.4f}; kernel launches "
                  f"{json.dumps(launches)}")
            for i, l in enumerate(all_losses):
                print(f"  step {i}: " + json.dumps({k: round(v, 5)
                                                    for k, v in l.items()}))
        roi = runs["int8_ps_roi"]["launches"]
        need = [n for n in roi if n not in (roi_align_cuda.__name__,
                                             roi_align_backward_cuda.__name__,
                                             "qconv_wgrad_cuda")]
        check(all(roi[n] > 0 for n in need),
              f"int8 RoI path: a kernel was not launched: {roi}")
        check(roi.get(roi_align_cuda.__name__, 0) == 0
              and roi.get(roi_align_backward_cuda.__name__, 0) == 0,
              f"int8 RoI path: K1 or K1b ran where K5 should: {roi}")
        # the two cached steps in turns on one batch: ps, roi, roi, ps, ...
        tr0 = raw["int8_ps_roi"][0]
        batch = tr0.train_loader._attach_store(tr0.train_loader.pack_batch(
            [0, 5, 9], [False, True, False]))
        view = lambda v: online_view_to_detections(v, dev)
        ab = {}
        for name in ("int8_ps", "int8_ps_roi", "int8_ps_roi",
                     "int8_ps") * 3:
            tr, step = raw[name]
            args = (torch.from_numpy(batch.images).to(dev),
                    torch.from_numpy(batch.image_hw).to(dev),
                    view(batch.online["RCNN"]), view(batch.online["RPN"]),
                    view(tr._pack_offline(batch)))
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.state, _ = step(tr.state, *args)
            torch.cuda.synchronize()
            ab.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
        ab_ms = {k: statistics.median(v) for k, v in ab.items()}
        print(f"[int8 RoI path] train_step_cached in turns (ps, roi, roi, "
              f"ps x 3; ms, host clock to a synchronize): medians "
              f"{json.dumps(ab_ms)}, all {_rounded(ab)}")
        return roi, dict(runs=runs, ab_ms=ab_ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _same_tree(torch, a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(torch, a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and bool(torch.equal(a, b.to(a.device)))
    return a == b


def phase_trainer_path(torch, dev, num_classes, counters):
    """CoinTrainer.train of foggy_fast.yaml as shipped, at full width, 8
    steps; the main path of this script. Returns the launches of every
    kernel in the run and its measurements."""
    import dataclasses
    from coin_tpu_torch.config import load_config
    from coin_tpu_torch.data.augment import normalize_batch
    from coin_tpu_torch.data.voc import (CITYSCAPES_CLASSES,
                                         make_synthetic_voc,
                                         register_pascal_voc)
    from coin_tpu_torch.engine import pipelines
    from coin_tpu_torch.engine import step_builder as sb
    from coin_tpu_torch.engine.checkpoint import state_tree
    from coin_tpu_torch.engine.pre_train import online_view_to_detections
    from coin_tpu_torch.engine.results_store import ResultStore
    from coin_tpu_torch.engine.trainer import CoinTrainer

    root = os.path.join(REPO, "output", "chip_smoke_trainer")
    shutil.rmtree(root, ignore_errors=True)
    try:
        voc = os.path.join(root, "foggy")
        make_synthetic_voc(voc, num_images=12, class_names=CITYSCAPES_CLASSES,
                           image_hw=(1024, 2048), seed=SEED, split="train")
        make_synthetic_voc(voc, num_images=4, class_names=CITYSCAPES_CLASSES,
                           image_hw=(1024, 2048), seed=SEED + 1, split="val")
        register_pascal_voc("chip_smoke_foggytrain", "foggy", "train",
                            CITYSCAPES_CLASSES, ".jpg")
        register_pascal_voc("chip_smoke_foggyval", "foggy", "val",
                            CITYSCAPES_CLASSES, ".jpg")
        npz = os.path.join(root, "GDINO_collect.npz")
        cfg = load_config(os.path.join(REPO,
                                       "configs/coin/GDINO/foggy_fast.yaml"))
        cfg.DATASETS.ROOT = root
        cfg.DATASETS.TRAIN_UNLABEL = ["chip_smoke_foggytrain"]
        cfg.DATASETS.TEST = ["chip_smoke_foggyval"]
        cfg.OUTPUT_DIR = os.path.join(root, "run")
        cfg.CLOUD.COLLECT_FILE = npz
        # the allowed cuts: burn-up at 4, the cache from step 0, prototype
        # updates from step 0, one eval at the end, no periodic checkpoint
        cfg.CLOUD.BURN_UP_STEP = 4
        cfg.TPU.CACHE_TEACHER_MIN_STEPS = 0
        cfg.CLOUD.PROTOTYPE_UPDATE_START = 0
        cfg.TEST.EVAL_PERIOD = 8
        cfg.SOLVER.CHECKPOINT_PERIOD = 10 ** 9
        g = cfg.get_path
        check((g("TPU.INT8_TRAIN"), g("TPU.INT8_COLLECT"),
               g("TPU.TEACHER_REFRESH_EPOCHS"), g("TPU.TEACHER_POST_NMS_TOPK"),
               g("TPU.TEACHER_PRE_NMS_TOPK"), cfg.SOLVER.IMG_PER_BATCH_UNLABEL,
               tuple(cfg.TPU.IMAGE_HW)) == (True, True, 4, 512, 3000, 3,
                                            (608, 1216)),
              "not foggy_fast.yaml as shipped")
        # a first store of random boxes; replaced below by one paired with
        # the teacher's detections
        ResultStore(num_classes).save(npz)
        t0 = time.perf_counter()
        tr = CoinTrainer(cfg)
        build_s = time.perf_counter() - t0
        m = tr.model
        check(m.quant_train_res5 == 1 and not m.quant_convs
              and m.compute_dtype == torch.bfloat16
              and m.text_trunk.layers == 12
              and all(p.dtype == torch.float32 for p in m.parameters())
              and tr.teacher_pcfg.post_nms_topk_test == 512
              and tr.pcfg.roi_batch_size == 512,
              "not the full-width foggy_fast detector (int8 res5, f32 "
              "masters, bf16 compute, teacher budget 512)")

        # the collection pass with INT8_COLLECT on and off (the first pass
        # of each warms it up); its host decode of the 12 images is included
        coll = {}
        for on in (True, False, True, False):
            tr.cfg.TPU.INT8_COLLECT = on
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            teacher_store = tr.collect_teacher_store()
            torch.cuda.synchronize()
            coll[on] = (time.perf_counter() - t0) * 1e3 / 12
        check(len(teacher_store) == 12 and all(
            teacher_store.has_view(i, "RCNN_FLIP")
            for i in teacher_store.image_ids()), "collection pass: views")
        # device time of one collection batch, int8 clone against bf16
        loader = tr._collect_loader
        batch, _ = next(iter(loader))
        images = normalize_batch(torch.from_numpy(batch.images).to(dev))
        hw = torch.from_numpy(batch.image_hw).to(dev)
        coll_dev = {}
        with torch.inference_mode():
            for on, model in ((True, tr.state.teacher.clone(True)),
                              (False, tr.state.teacher)):
                text = model.text_features(tr.tokens)
                coll_dev[on] = time_ms(torch, lambda: pipelines.inference(
                    model, images, hw, tr.tokens, tr.teacher_pcfg,
                    text_features=text), iters=5, warmup=1) / len(batch.images)
        print(f"[trainer path] CoinTrainer(foggy_fast.yaml) built in "
              f"{build_s:.1f} s; collection pass (12 images, both "
              f"orientations, host decode included) ms per image: INT8_COLLECT "
              f"on {coll[True]:.2f}, off {coll[False]:.2f}; device ms per "
              f"image of one batch of 4 (both orientations are two such "
              f"calls): int8 clone {coll_dev[True]:.3f}, bf16 "
              f"{coll_dev[False]:.3f}")

        # the cloud store, paired with the teacher's detections
        _cloud_store(torch, ResultStore(num_classes), teacher_store,
                     tr.train_loader, num_classes, SEED).save(npz)
        tr.store = tr.train_loader.store = ResultStore.load(npz)

        # the run: every step and collection pass timed to a synchronize
        seq, times, all_losses = [], {}, []

        def timed(name, fn, keep_losses=False):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                times.setdefault(name, []).append(
                    (time.perf_counter() - t) * 1e3)
                seq.append(name)
                if keep_losses:
                    all_losses.append({k: v.item() for k, v in
                                       out[1].items()})
                return out
            return run
        for attr in ("_train_step", "_train_step_cached",
                     "_train_step_cached_two"):
            setattr(tr, attr, timed(attr[1:], getattr(tr, attr), True))
        for attr in ("collect_teacher_store", "test", "test_teacher"):
            setattr(tr, attr, timed(attr, getattr(tr, attr)))
        tr.teacher_store = None
        tr.cfg.TPU.INT8_COLLECT = True
        before = {"student": _snapshot(tr.state.model),
                  "teacher": _snapshot(tr.state.teacher)}
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = tr.train(max_iter=8)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        want = (["collect_teacher_store"] + ["train_step_cached"] * 4
                + ["collect_teacher_store"] + ["train_step_cached_two"] * 4
                + ["test", "test_teacher"])
        print(f"[trainer path] train(max_iter=8): {run_s:.3f} s; sequence "
              f"{json.dumps(seq)}; kernel launches {json.dumps(launches)}")
        for i, l in enumerate(all_losses):
            print(f"  step {i}: " + json.dumps({k: round(v, 5)
                                                for k, v in l.items()}))
        check(seq == want, f"trainer path: sequence {seq}")
        check(all(v > 0 for v in launches.values()),
              f"a kernel was not launched on the trainer path: {launches}")
        check(all(math.isfinite(v) for l in all_losses for v in l.values()),
              "a loss is not finite")
        check(state.step == 8 and os.path.exists(os.path.join(
            cfg.OUTPUT_DIR, "checkpoints", "burn_up_0000003")),
              "steps or the burn-up checkpoint missing")
        moved = {k: len(_moved(mod, before[k])) for k, mod in
                 (("student", state.model), ("teacher", state.teacher))}
        check(all(moved.values()), f"state did not move: {moved}")
        aps = (tr.ap_50_student.get(7), tr.ap_50_offline_teacher.get(7))
        check(all(a is not None and 0.0 <= a <= 100.0 for a in aps),
              f"eval AP50 {aps}")
        rows = [json.loads(line) for line in open(
            os.path.join(cfg.OUTPUT_DIR, "metrics.json"))]
        check(rows and all(math.isfinite(v) for r in rows
                           for k, v in r.items() if k.startswith("loss")),
              "metrics.json: a logged loss is not finite")
        step_ms = {k: statistics.median(v[1:] or v) for k, v in times.items()
                   if k.startswith("train_step")}
        print(f"[trainer path] ms per step (host clock to a synchronize; "
              f"median after the first of each flavor): "
              f"{json.dumps(step_ms)}, all: "
              f"{json.dumps({k: [round(t, 3) for t in v] for k, v in times.items()})}"
              f"; images/s of the cached step "
              f"{3000.0 / step_ms['train_step_cached']:.2f}; peak device "
              f"memory {mem:.1f} GiB; parameter tensors moved {moved}; "
              f"AP50 student {aps[0]:.4f}, teacher {aps[1]:.4f}")

        # checkpoint: save, move the state by one step, restore, compare
        path = tr.checkpointer.save(state, 8)
        saved = state_tree(state)
        marks = []

        def on_stage(name):
            marks.append((name, torch.cuda.Event(enable_timing=True)))
            marks[-1][1].record()
        hyper = dataclasses.replace(sb.hyper_from_cfg(tr.cfg),
                                    loss_weights=tr.loss_weights)
        _, timed_cached, _ = sb.build_adaptation_steps(
            tr.tokens, tr.pcfg, tr.teacher_pcfg, hyper, on_stage=on_stage)
        batch = tr.train_loader._attach_store(tr.train_loader.pack_batch(
            [0, 5, 9], [False, True, False]))
        view = lambda v: online_view_to_detections(v, dev)
        args = (torch.from_numpy(batch.images).to(dev),
                torch.from_numpy(batch.image_hw).to(dev),
                view(batch.online["RCNN"]), view(batch.online["RPN"]),
                view(tr._pack_offline(batch)))
        stages = []
        for _ in range(4):
            marks.clear()
            on_stage("start")
            state, _ = timed_cached(state, *args)
            torch.cuda.synchronize()
            stages.append({name: marks[i][1].elapsed_time(e)
                           for i, (name, e) in enumerate(marks[1:])})
        stage_ms = {k: statistics.median(s[k] for s in stages[1:])
                    for k in stages[0]}
        print(f"[trainer path] cached step by stage, ms (median of 3 after a "
              f"warm-up, CUDA events at build_adaptation_steps' stage "
              f"marks; student_forward includes matching): "
              f"{json.dumps(stage_ms)}")
        check(not _same_tree(torch, saved, state_tree(state)),
              "checkpoint: the extra steps did not move the state")
        tr.checkpointer.load(path, state)
        check(_same_tree(torch, saved, state_tree(state)),
              "checkpoint: the restored state differs from the saved one")
        print(f"[trainer path] checkpoint {os.path.basename(path)}: saved, "
              f"moved by 4 steps, restored: every tensor, count, step and "
              f"the generator equal")
        share_launches, share_ms = _share_crops_pass(torch, tr, cfg)
        return launches, dict(step_ms=step_ms, stage_ms=stage_ms,
                              collect_ms_per_image=coll,
                              collect_device_ms_per_image=coll_dev,
                              peak_gib=mem, share_launches=share_launches,
                              share_collect_ms_per_image=share_ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ----------------------------------------------- collection-path kernels
# Swin-B on the 4 x 608 x 1216 canvas: (windows per image, heads, width,
# padded H, padded W, blocks) of each stage; windows of 12 x 12 tokens
SWINB_STAGES = ((338, 4, 128, 156, 312, 2), (91, 8, 256, 84, 156, 2),
                (28, 16, 512, 48, 84, 18), (8, 32, 1024, 24, 48, 2))
# GDINO's levels on that canvas: strides 8, 16, 32 and the extra one
GDINO_LEVELS = ((76, 152), (38, 76), (19, 38), (10, 19))
# the cloud teacher at full width: Swin-B, 900 queries, 6 encoder and 6
# decoder layers, BERT-base with 30 522 rows
GDINO = dict(variant="swinB", queries=900, layers=6, bert_layers=12,
             bert_vocab=30522)


def _sum_cases(cases, weight):
    """The kernels-line numbers of one forward: each case times its
    launches per forward."""
    out = {k: sum(c[k] * c[weight] for c in cases)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    by = max(cases, key=lambda c: c["bound_ms"] * c[weight])["bound_by"]
    return dict(bound_by=by, **out)


def phase_window_attention(torch, dev, gen):
    """K9 at every Swin-B stage of the collection batch, shifted and not,
    in f32 and bf16, against its plain version. Library yardstick:
    scaled_dot_product_attention with the bias plus the shift mask as a
    float mask (timed only). Bound: qkv read and the output written once,
    against the two products at the bf16 tensor-core rate."""
    from coin_tpu_torch.kernels.window_attention import window_attention_cuda
    from coin_tpu_torch.models import swin
    F = torch.nn.functional
    n, d = 144, 32
    index = torch.from_numpy(swin._rel_pos_index(12)).to(dev)
    cases, worst = [], 0.0
    for nw, heads, dim, hp, wp, blocks in SWINB_STAGES:
        bn = 4 * nw
        qkv = torch.randn((bn, n, 3, heads, d), generator=gen).to(dev)
        table = (torch.randn((23 * 23, heads), generator=gen) * 0.5).to(dev)
        mask = torch.from_numpy(swin._attn_mask(hp, wp, 12, 6)).to(dev)
        check(mask.shape[0] == nw, f"window_attention: {mask.shape[0]} "
              f"windows, expected {nw}")
        errs = {}
        for shifted in (False, True):
            m = mask if shifted else None
            for dtype in (torch.float32, torch.bfloat16):
                q = qkv.to(dtype)
                got = window_attention_cuda(q, table, index, m).float()
                want = swin.window_attention_plain(q, table, index,
                                                   m).float()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * scale
                check(err <= tol, f"window_attention width {dim} shifted "
                      f"{shifted} {dtype}: max abs err {err} > {tol}")
                errs[f"{'shift' if shifted else 'plain'} "
                     f"{str(dtype)[6:]}"] = err
                worst = max(worst, err)
        q = qkv.to(torch.bfloat16)
        ms = time_ms(torch, lambda: window_attention_cuda(q, table, index,
                                                          mask))
        plain_ms = time_ms(torch, lambda: swin.window_attention_plain(
            q, table, index, mask), iters=3, warmup=1)
        bias = table[index.reshape(-1).long()].reshape(n, n, heads)
        amask = (bias.permute(2, 0, 1)[None] + mask[:, None]).to(
            torch.bfloat16)
        amask = amask[None].expand(4, -1, -1, -1, -1).reshape(bn, heads, n, n)
        qs, ks, vs = (q[:, :, i].transpose(1, 2) for i in range(3))
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=amask))
        nbytes = q.numel() * 2 + bn * n * dim * 2 + mask.numel() * 4 \
            + table.numel() * 4 + index.numel() * 4
        b_ms, b_by = bound(nbytes, 4 * n * n * d * bn * heads, BF16_FLOPS)
        cases.append(dict(case=f"stage width {dim}", blocks=blocks,
                          windows=bn, heads=heads, max_abs_err=errs, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by))
        print(f"[K9 window_attention] width {dim}: {bn} windows x {heads} "
              f"heads of {n} tokens (x{blocks} blocks per forward): max abs "
              f"err {json.dumps(errs)} (tol f32 1e-5, bf16 2**-7 x max "
              f"|out|); shifted bf16 {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        del qkv, q, amask, qs, ks, vs
    torch.cuda.empty_cache()
    tot = _sum_cases(cases, "blocks")
    print(f"[K9 window_attention] one Swin-B forward (24 launches): "
          f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f}, SDPA "
          f"{tot['library_ms']:.3f}, bound {tot['bound_ms']:.4f} ms")
    return dict(name="window_attention", route="cuda",
                source="coin_tpu_torch/csrc/window_attention.cu",
                replaces="coin_tpu/models/swin.py:57", max_abs_err=worst,
                cases=cases, **tot)


def _grid_sample_deform(torch, values, shapes, loc, weights):
    """The official PyTorch fallback of MSDeformAttn (one grid_sample per
    level), the library yardstick of K7; used nowhere in the port."""
    F = torch.nn.functional
    b, _, h, d = values.shape
    q, nl, npt = loc.shape[1], loc.shape[3], loc.shape[4]
    splits = values.split([hh * ww for hh, ww in shapes], dim=1)
    grids = (2 * loc - 1).to(values.dtype)
    sampled = []
    for lvl, (hh, ww) in enumerate(shapes):
        v = splits[lvl].flatten(2).transpose(1, 2).reshape(b * h, d, hh, ww)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
        sampled.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))
    w = weights.transpose(1, 2).reshape(b * h, 1, q, nl * npt).to(
        values.dtype)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * w).sum(-1)
    return out.view(b, h * d, q).transpose(1, 2).reshape(b, q, h, d)


def phase_ms_deform(torch, dev, gen):
    """K7 at the encoder's shape (4 x 15 352 queries over the 4 levels)
    and the decoder's (4 x 900), f32 and bf16, against its plain version;
    library yardstick: grid_sample per level. Bound: values, locations and
    weights read once, the output written once, against the f32
    operations of the taps."""
    from coin_tpu_torch.kernels.ms_deform import ms_deform_cuda
    from coin_tpu_torch.models import deformable as dfm
    shapes = [list(s) for s in GDINO_LEVELS]
    starts = [0]
    for hh, ww in shapes[:-1]:
        starts.append(starts[-1] + hh * ww)
    total = starts[-1] + shapes[-1][0] * shapes[-1][1]
    shapes_t, starts_t, _ = dfm._level_tensors(shapes, starts, dev)
    values = torch.randn((4, total, 8, 32), generator=gen).to(dev)
    cases, worst = [], 0.0
    for label, q in (("encoder", total), ("decoder", 900)):
        loc = (torch.rand((4, q, 8, 4, 4, 2), generator=gen) * 1.2
               - 0.1).to(dev)
        w = torch.softmax(torch.randn((4, q, 8, 16), generator=gen),
                          -1).reshape(4, q, 8, 4, 4).to(dev)
        # f32: the kernel repeats the plain version's rounding (1e-5). bf16:
        # the kernel reads bf16 values and computes in f32, so it is within
        # one bf16 rounding of the plain version run in f32 on the same
        # bf16 values; JAX's order (the plain version in bf16) rounds every
        # tap, product and sum to bf16, about 150 roundings per output
        v = values.to(torch.bfloat16)
        want32 = dfm.ms_deform_sample_plain(values, shapes, starts, loc, w)
        got32 = ms_deform_cuda(values, shapes_t, starts_t, loc, w)
        scale = want32.abs().max().item()
        errs = {"float32": (got32 - want32).abs().max().item()}
        check(errs["float32"] <= 1e-5 * max(scale, 1.0),
              f"ms_deform {label} f32: max abs err {errs['float32']}")
        want_b = dfm.ms_deform_sample_plain(v.float(), shapes, starts, loc, w)
        got_b = ms_deform_cuda(v, shapes_t, starts_t, loc, w).float()
        ulp = torch.ldexp(torch.ones_like(want_b), torch.frexp(
            want_b.abs()).exponent - 8)
        over = (got_b - want_b).abs() > ulp + 1e-5 * max(scale, 1.0)
        errs["bfloat16"] = (got_b - want_b).abs().max().item()
        check(not bool(over.any()), f"ms_deform {label} bf16: "
              f"{int(over.sum())} values off by more than one bf16 rounding")
        jax_order = dfm.ms_deform_sample_plain(v, shapes, starts, loc,
                                               w).float()
        errs["bfloat16_vs_jax_order"] = (got_b - jax_order).abs().max().item()
        check(errs["bfloat16_vs_jax_order"] <= 5e-2 * scale,
              f"ms_deform {label}: bf16 kernel vs JAX's bf16 order "
              f"{errs['bfloat16_vs_jax_order']}")
        worst = max(worst, errs["float32"], errs["bfloat16"])
        lib_err = (_grid_sample_deform(torch, values, shapes, loc, w)
                   - ms_deform_cuda(values, shapes_t, starts_t, loc, w)
                   ).abs().max().item()
        ms = time_ms(torch, lambda: ms_deform_cuda(v, shapes_t, starts_t,
                                                   loc, w))
        plain_ms = time_ms(torch, lambda: dfm.ms_deform_sample_plain(
            v, shapes, starts, loc, w), iters=3, warmup=1)
        lib_ms = time_ms(torch, lambda: _grid_sample_deform(
            torch, v, shapes, loc, w))
        nbytes = v.numel() * 2 + loc.numel() * 4 + w.numel() * 4 \
            + 4 * q * 8 * 32 * 2
        b_ms, b_by = bound(nbytes, 4 * q * 8 * 16 * (32 * 9 + 20))
        cases.append(dict(case=label, per_forward=6, queries=q,
                          max_abs_err=errs, grid_sample_err_f32=lib_err,
                          ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by))
        print(f"[K7 ms_deform {label}] values {tuple(v.shape)}, 4 x {q} "
              f"queries x 8 heads x 4 levels x 4 points: max abs err "
              f"{json.dumps(errs)} (tol f32 1e-5 x max(1, max |out|); bf16 one "
              f"bf16 rounding of the f32 result on the same values; against "
              f"JAX's order, which rounds each tap to bf16, 5e-2 x max "
              f"|out|); grid_sample's f32 result differs by "
              f"{lib_err:.3g}; bf16 {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"grid_sample {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    del values
    tot = _sum_cases(cases, "per_forward")
    print(f"[K7 ms_deform] one GDINO forward (6 encoder + 6 decoder "
          f"launches): {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f}, "
          f"grid_sample {tot['library_ms']:.3f}, bound "
          f"{tot['bound_ms']:.4f} ms")
    return dict(name="ms_deform", route="cuda",
                source="coin_tpu_torch/csrc/ms_deform.cu",
                replaces="coin_tpu/models/deformable.py:20",
                max_abs_err=worst, cases=cases, **tot)


def _fusion_inputs(torch, gen, b=4, n=256, c1=9):
    """GDINO-like rows on the 608 x 1216 canvas: boxes around 48 centres
    per image (so clusters form), probs with a zero background column
    renormalised as postprocess_gdino leaves them, 80 % valid."""
    centres = torch.rand((b, 48, 2), generator=gen) * torch.tensor(
        [1100.0, 540.0])
    pick = torch.randint(0, 48, (b, n), generator=gen)
    xy = torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2)) \
        + torch.randn((b, n, 2), generator=gen) * 6
    wh = 24 + torch.rand((b, n, 2), generator=gen) * 96
    boxes = torch.cat([xy, xy + wh], -1)
    fg = torch.softmax(torch.randn((b, n, c1 - 1), generator=gen) * 2, -1)
    probs = torch.cat([fg, torch.zeros((b, n, 1))], -1)
    classes = fg.argmax(-1).int()
    valid = torch.rand((b, n), generator=gen) < 0.8
    classes = torch.where(valid, classes, torch.full_like(classes, -1))
    return boxes, probs, classes, valid


def phase_fusion_nms(torch, dev, gen):
    """K6 on 4 x 256 x 9 (the collection batch: capacity 256, 8 Foggy
    classes + background) with the 'ms' pair (max score, s-avg box) and one
    case for each other method, against the plain version on the CPU: the
    same rows and classes, values within 1e-5 of max(1, |value|). No
    PyTorch call computes this function (library: none). Bound: the rows
    read and written once against the operations this run's clusters
    need, at the f32 rate."""
    from coin_tpu_torch.kernels.fusion_nms import fusion_nms_cuda
    from coin_tpu_torch.ops import nms as nms_ops
    from coin_tpu_torch.structures import Detections
    boxes, probs, classes, valid = _fusion_inputs(torch, gen)
    det = Detections(boxes=boxes, scores=probs[..., :-1].amax(-1),
                     classes=classes, valid=valid, probs=probs)
    ddev = det.map(lambda t: t.to(dev))
    cases = []
    for sm, bm in (("max", "s-avg"), ("probEn", "avg"), ("avg", "max")):
        got = nms_ops.fusion_nms(ddev, 0.6, sm, bm).map(lambda t: t.cpu())
        want = nms_ops.fusion_nms(det, 0.6, sm, bm)
        check(torch.equal(got.valid, want.valid)
              and torch.equal(got.classes, want.classes),
              f"fusion_nms {sm}/{bm}: rows or classes differ")
        err = max(((getattr(got, f) - getattr(want, f)).abs()
                   / getattr(want, f).abs().clamp_min(1.0)).max().item()
                  for f in ("boxes", "scores", "probs"))
        check(err <= 1e-5, f"fusion_nms {sm}/{bm}: relative err {err}")
        kept = want.valid.sum(-1).tolist()
        si, bi = nms_ops.SCORE_METHODS.index(sm), nms_ops.BOX_METHODS.index(bm)
        args = (ddev.boxes, ddev.probs, ddev.classes, ddev.valid, 0.6)
        ms = time_ms(torch, lambda: fusion_nms_cuda(*args, si, bi))
        plain_ms = time_ms(torch, lambda: nms_ops.fusion_nms_plain(
            *args, sm, bm), iters=3, warmup=1)
        b_, n, c1 = probs.shape
        nbytes = 2 * b_ * n * (4 + c1 + 2) * 4
        # per emitted cluster: n IoUs (~15 operations) and the cluster's
        # sums over n rows of c1 + 5 values; the logs of probEn once
        b_ms, b_by = bound(nbytes, sum(kept) * n * (15 + 2 * (c1 + 5))
                           + b_ * n * c1 * 10)
        cases.append(dict(case=f"{sm}/{bm}", clusters=kept,
                          max_rel_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=None))
        print(f"[K6 fusion_nms {sm}/{bm}] 4 x {n} rows x {c1} probs, IoU "
              f"0.6, {int(valid.sum())} valid -> clusters per image {kept}: "
              f"rows and classes identical, max rel err {err:.3g} (tol "
              f"1e-5); {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.5f} ms ({b_by})")
    a = cases[0]
    return dict(name="fusion_nms", route="cuda",
                source="coin_tpu_torch/csrc/fusion_nms.cu",
                replaces="coin_tpu/ops/nms.py:137",
                max_abs_err=max(c["max_rel_err"] for c in cases),
                ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
                bound_by=a["bound_by"], library_ms=None, cases=cases)


# ------------------------------------------------ the GDINO teacher
def gdino_checkpoint():
    """A random Swin-B GroundingDINO checkpoint (900 queries, 6 + 6
    layers, BERT-base with 30 522 rows) in the official key layout:
    manifests.gdino_manifest with synth_state_dict's N(0, 0.02²) values,
    the norms' scales moved near 1 so that activations stay away from
    zero. numpy arrays, about 0.9 GB."""
    import numpy as np
    from coin_tpu_torch.models.manifests import (gdino_manifest,
                                                 synth_state_dict)
    keys, _ = gdino_manifest(GDINO["variant"], GDINO["layers"],
                             GDINO["layers"], GDINO["queries"],
                             GDINO["bert_layers"], GDINO["bert_vocab"])
    sd = synth_state_dict(keys, seed=SEED)
    rng = np.random.RandomState(SEED + 7)
    for k, v in sd.items():
        if v.ndim == 1 and k.endswith(".weight") and (
                "norm" in k or "LayerNorm" in k or ".1.weight" in k):
            sd[k] = (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
    return sd


def phase_gdino_reference(torch, dev, sd):
    """The full-width Swin-B GDINO and BERT-base in f32 on the card
    (kernels) against the same weights on the CPU (plain versions), TF32
    off, on 2 x 192 x 256 (the smallest canvas of the 32-multiple ones
    near 128 x 256 whose 1020 encoder tokens cover the 900 queries):
    stage by stage, the decoder from the CPU's selected boxes on both
    sides."""
    from coin_tpu_torch.data.augment import normalize_batch
    from coin_tpu_torch.device import parity_numerics
    from coin_tpu_torch.models.bert import BertModel
    from coin_tpu_torch.models.convert_gdino import (bert_state_dict,
                                                     convert_gdino)
    from coin_tpu_torch.models.gdino import GroundingDINO
    from coin_tpu_torch.models.gdino_detector import (IMAGENET_MEAN,
                                                      IMAGENET_STD)
    parity_numerics()
    variant, nq, nl = GDINO["variant"], GDINO["queries"], GDINO["layers"]
    gsd = convert_gdino(sd, variant, nl, nl)
    bcfg, bsd = bert_state_dict(sd)
    gen = torch.Generator().manual_seed(SEED + 20)
    cells = torch.randint(0, 256, (2, 12, 16, 3), generator=gen,
                          dtype=torch.uint8)
    images_u8 = cells.repeat_interleave(16, 1).repeat_interleave(16, 2)
    ids = torch.randint(1000, 30000, (2, 14), generator=gen)
    tmask = torch.ones((2, 14), dtype=torch.bool)
    tmask[1, 11:] = False
    smask = tmask[:, None, None, :].expand(2, 1, 14, 14).clone()
    out = {}
    for name, d in (("cpu", "cpu"), ("gpu", dev)):
        model = GroundingDINO(variant, nq, nl, nl).to(d)
        model.load_state_dict(gsd, strict=True)
        bert = BertModel(bcfg).to(d)
        bert.load_state_dict(bsd, strict=True)
        t = lambda x: x.to(d)
        with torch.inference_mode():
            emb = bert(t(ids), t(tmask))
            images = normalize_batch(t(images_u8), IMAGENET_MEAN,
                                     IMAGENET_STD)
            feats = model.backbone(images)
            src, pos, shapes, starts = model.project(feats)
            src, lang = model.enhance(src, pos, shapes, starts, emb,
                                      t(tmask), t(smask))
            ref = model.select_queries(src, lang, t(tmask), shapes)
            ref_cpu = ref if name == "cpu" else out["cpu"]["ref"].to(d)
            logits, boxes = model.decode(src, lang, t(tmask), ref_cpu,
                                         shapes, starts)
        out[name] = {k: v.cpu() if isinstance(v, torch.Tensor) else
                     [f.cpu() for f in v] for k, v in dict(
                         bert=emb, feats=feats, src=src, lang=lang, ref=ref,
                         logits=logits, boxes=boxes).items()}
        del model, bert
    torch.cuda.empty_cache()
    check(shapes == [(24, 32), (12, 16), (6, 8), (3, 4)], f"{shapes}")

    def rel(a, b):
        finite = torch.isfinite(b)
        check(torch.equal(torch.isfinite(a), finite), "non-finite mismatch")
        return ((a - b)[finite].abs().max() / b[finite].abs().max()).item()
    g, c = out["gpu"], out["cpu"]
    errs = {"bert": rel(g["bert"], c["bert"]),
            "swin": max(rel(a, b) for a, b in zip(g["feats"], c["feats"])),
            "enhanced_image": rel(g["src"], c["src"]),
            "enhanced_text": rel(g["lang"], c["lang"]),
            "logits": rel(g["logits"], c["logits"]),
            "boxes": rel(g["boxes"], c["boxes"])}
    same_sel = ((g["ref"] - c["ref"]).abs().amax(-1) < 1e-4).float().mean()
    print(f"[GDINO reference] Swin-B GDINO + BERT-base in f32, card vs "
          f"CPU, 2 x 192 x 256, 14 tokens (3 padded): relative max errors "
          f"{json.dumps(errs)} (tol 1e-3; the decoder from the CPU's "
          f"selected boxes); selected boxes that agree within 1e-4: "
          f"{same_sel.item():.4f}")
    check(all(v <= 1e-3 for v in errs.values()), f"GDINO reference: {errs}")
    check(same_sel.item() >= 0.99, "GDINO reference: query selection")


def _synthetic_vocab(path, class_names):
    """A vocab.txt of BERT-base's 30 522 rows: the special tokens where
    bert-base-uncased has them, the class words, '.', and filler."""
    words = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] \
        + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", "."]
    for name in class_names:
        words += [w for w in name.lower().split() if w not in words]
    words += [f"tok{i}" for i in range(30522 - len(words))]
    with open(path, "w") as f:
        f.write("\n".join(words) + "\n")


def phase_collect_path(torch, dev, sd, counters):
    """The collection pass with the cloud teacher: build_cloud_detector
    of foggy_fast.yaml's GDINO teacher (Swin-B, 900 queries, 6 + 6
    layers, BERT-base; bf16 over f32 parameters) from a checkpoint file
    in the official layout, then collect_cloud with CLOUD.NMS_METHOD 'ms'
    over the 12 synthetic 1024 x 2048 images of the trainer path (3
    batches of 4 on 608 x 1216); the npz saved, loaded and packed as the
    trainer reads it. K4n, K6, K7 and K9 must launch."""
    import tempfile
    import numpy as np
    from coin_tpu_torch.config import load_config
    from coin_tpu_torch.data.augment import normalize_batch
    from coin_tpu_torch.data.loader import TestLoader, _resize_factor
    from coin_tpu_torch.data.voc import (CITYSCAPES_CLASSES,
                                         make_synthetic_voc,
                                         register_pascal_voc)
    from coin_tpu_torch.engine import collect as collect_mod
    from coin_tpu_torch.engine.cloud_factory import build_cloud_detector
    from coin_tpu_torch.engine.results_store import ResultStore
    from coin_tpu_torch.models.gdino_detector import (IMAGENET_MEAN,
                                                      IMAGENET_STD,
                                                      postprocess_gdino)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gdino_")
    root = os.path.join(REPO, "output", "chip_smoke_collect")
    shutil.rmtree(root, ignore_errors=True)
    try:
        ckpt = os.path.join(tmp, "groundingdino_swinb_random.pth")
        t0 = time.perf_counter()
        torch.save({"model": {k: torch.from_numpy(v)
                              for k, v in sd.items()}}, ckpt)
        save_s = time.perf_counter() - t0
        vocab = os.path.join(tmp, "vocab.txt")
        _synthetic_vocab(vocab, CITYSCAPES_CLASSES)
        make_synthetic_voc(os.path.join(root, "foggy"), num_images=12,
                           class_names=CITYSCAPES_CLASSES,
                           image_hw=(1024, 2048), seed=SEED, split="train")
        register_pascal_voc("chip_smoke_collect", "foggy", "train",
                            CITYSCAPES_CLASSES, ".jpg")
        cfg = load_config(os.path.join(REPO,
                                       "configs/coin/GDINO/foggy_fast.yaml"))
        cfg.MODEL.TEACHER_CLOUD.WEIGHT = ckpt
        cfg.TPU.BERT_VOCAB = vocab
        tc, ctc = cfg.MODEL.TEACHER_CLOUD, cfg.CLOUD.TEACHER_CLOUD
        itc = cfg.INPUT.TEACHER_CLOUD
        check((tc.META_ARCHITECTURE, tc.TYPE, tc.TEST_THRESHOLD,
               cfg.CLOUD.NMS_METHOD, ctc.COLLECT_NMS_THRESH,
               ctc.RCNN_THRESH, itc.MIN_SIZE_TEST)
              == ("GDINO", GDINO["variant"], 0.25, "ms", 0.6, 0.25, 600),
              "not foggy_fast.yaml's cloud teacher")
        t0 = time.perf_counter()
        det = build_cloud_detector(cfg, "GDINO", CITYSCAPES_CLASSES,
                                   device=dev)
        build_s = time.perf_counter() - t0
        model = det.model
        nl = GDINO["layers"]
        check(model.dtype == torch.bfloat16
              and model.num_queries == GDINO["queries"]
              and (model.enc_layers, model.dec_layers) == (nl, nl)
              and model.variant == GDINO["variant"]
              and all(p.dtype == torch.float32 for p in model.parameters())
              and det.bert.config.num_hidden_layers == GDINO["bert_layers"]
              and det.bert.config.vocab_size == GDINO["bert_vocab"]
              and det.capacity == 256,
              "not the full-width Swin-B GDINO with BERT-base")
        loader = TestLoader("chip_smoke_collect", root, batch_size=4,
                            min_size=itc.MIN_SIZE_TEST,
                            max_size=itc.get("MAX_SIZE_TEST", 1333))
        check(tuple(loader.canvas_hw) == (608, 1216), f"{loader.canvas_hw}")
        kw = dict(nms_method=cfg.CLOUD.NMS_METHOD,
                  collect_nms_thresh=ctc.COLLECT_NMS_THRESH,
                  rcnn_thresh=ctc.RCNN_THRESH,
                  rpn_thresh=(ctc.RPN_THRESH if ctc.RPN_SEPARATE_COLLECT
                              else ctc.RCNN_THRESH))
        kw["device"] = dev
        collect_mod.collect_cloud(det, loader, 8, **kw)        # warm-up
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store = collect_mod.collect_cloud(det, loader, 8, **kw)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        mem = torch.cuda.max_memory_allocated() / 2 ** 30

        npz = os.path.join(root, "GDINO_collect.npz")
        store.save(npz)
        back = ResultStore.load(npz)
        ids = [r["image_id"] for r in loader.records]
        check(sorted(back.image_ids()) == sorted(ids), "store image ids")
        counts = {"RCNN": [], "RPN": []}
        for rec in loader.records:
            for view in counts:
                v = back.get_view(rec["image_id"], view)
                n = len(v["scores"])
                counts[view].append(n)
                check(v["probs"].shape == (n, 9) and bool(np.isfinite(
                    v["boxes"]).all()) and bool((v["scores"] >= 0.25).all())
                      and bool((v["scores"] <= 1.0).all()),
                      f"store view {view} of {rec['image_id']}")
                scale = _resize_factor(rec["height"], rec["width"],
                                       loader.min_size, loader.max_size)
                packed = back.pack_view(rec["image_id"], view, 128, scale,
                                        False, float(loader.canvas_hw[1]))
                check(int(packed["valid"].sum()) == min(n, 128),
                      "pack_view")
        check(sum(counts["RCNN"]) > 0, "the collection stored nothing")

        # one batch on the device: the whole call, then stage by stage
        fusion = collect_mod.parse_nms_method(cfg.CLOUD.NMS_METHOD)
        batch, _ = next(iter(loader))
        u8 = torch.from_numpy(batch.images).to(dev)
        hw = torch.from_numpy(batch.image_hw).to(dev)
        b = u8.shape[0]
        with torch.inference_mode():
            batch_ms = time_ms(torch, lambda: collect_mod.postprocess(
                det(u8, hw), fusion, 0.6), iters=5, warmup=1)
            emb = det.embeds.expand(b, -1, -1)
            tmask = det.text_mask.expand(b, -1)
            smask = det.self_mask.expand(b, -1, -1, -1)
            marks, splits = [], []
            for _ in range(4):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
                ev[0].record()
                images = normalize_batch(u8, IMAGENET_MEAN, IMAGENET_STD)
                feats = model.backbone(images.to(model.dtype))
                ev[1].record()
                src, pos, shapes, starts = model.project(feats)
                src, lang = model.enhance(src, pos, shapes, starts, emb,
                                          tmask, smask)
                ev[2].record()
                ref = model.select_queries(src, lang, tmask, shapes)
                logits, boxes = model.decode(src, lang, tmask, ref, shapes,
                                             starts)
                ev[3].record()
                raw = postprocess_gdino(logits, boxes, det.positive_map, hw,
                                        det.threshold, det.capacity)
                fused = collect_mod.postprocess(raw, fusion, 0.6)
                ev[4].record()
                torch.cuda.synchronize()
                splits.append([ev[i].elapsed_time(ev[i + 1])
                               for i in range(4)])
        stage_ms = dict(zip(("normalize_and_swin",
                             "projections_and_enhancer",
                             "query_selection_and_decoder",
                             "postprocess_and_fusion_nms"),
                            (statistics.median(s[i] for s in splits[1:])
                             for i in range(4))))
        check(shapes == [tuple(s) for s in GDINO_LEVELS],
              f"feature levels {shapes}")
        before = raw.valid.sum(-1).tolist()
        after = fused.valid.sum(-1).tolist()
        print(f"[collect path] build_cloud_detector(foggy_fast.yaml, "
              f"'GDINO') from a {os.path.getsize(ckpt) / 2 ** 30:.2f} GiB "
              f"checkpoint (written in {save_s:.1f} s) in {build_s:.1f} s; "
              f"collect_cloud over 12 images (3 batches of 4 on 608 x 1216, "
              f"NMS_METHOD ms): {run_s:.3f} s, "
              f"{run_s * 1e3 / 12:.2f} ms per image with host decode; "
              f"device {batch_ms:.3f} ms per batch of 4 "
              f"({batch_ms / 4:.3f} ms per image); peak device memory "
              f"{mem:.2f} GiB; kernel launches {json.dumps(launches)}")
        print(f"[collect path] one batch by stage, ms (median of 3 after a "
              f"warm-up, CUDA events): {json.dumps(stage_ms)}; detections "
              f"per image before fusion NMS {before}, after {after}; stored "
              f"per image RCNN {counts['RCNN']}, RPN {counts['RPN']}")
        check(all(v > 0 for v in launches.values()),
              f"a kernel was not launched on the collection path: "
              f"{launches}")
        return launches, dict(ms_per_image=run_s * 1e3 / 12,
                              batch_ms=batch_ms, stage_ms=stage_ms,
                              peak_gib=mem, store=store)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------ the GLIP teacher
# GLIP-L of configs/coin/GLIP/foggy.yaml: Swin-L, 8 VLDyHead blocks,
# BERT-base; its levels P3-P7 on the 4 x 608 x 1216 canvas
GLIP = dict(variant="swinL", blocks=8, bert_layers=12, bert_vocab=30522)
GLIP_LEVELS = ((76, 152), (38, 76), (19, 38), (10, 19), (5, 10))


def _deform_calls():
    """K8's distinct call shapes in one VLDyHead block, with their count:
    the mid branch on every level, the high branch on P4-P7 (the same
    shapes), the low branch from the finer level at stride 2 onto P4-P7;
    13 calls per block."""
    calls = []
    for lvl, hw in enumerate(GLIP_LEVELS):
        calls.append((f"P{lvl + 3} stride 1", hw, 1, 1 if lvl == 0 else 2))
    for lvl in range(1, len(GLIP_LEVELS)):
        calls.append((f"P{lvl + 2} onto P{lvl + 3} stride 2",
                      GLIP_LEVELS[lvl - 1], 2, 1))
    return calls


def phase_deform_conv(torch, dev, gen):
    """K8 at every call shape of GLIP-L's collection batch (256 -> 256
    channels, f32, TF32 off), against its plain version, with offsets of
    up to 3 pixels that put taps outside the map and a non-unit mask.
    Library: PyTorch has no modulated deformable conv (torchvision is
    absent), so none; as context only, cuDNN's dense f32 3x3 conv of the
    same shape (not the same function). Bound: the operations,
    2 x 9 x 256 x 256 per output position, on the f32 CUDA cores."""
    from coin_tpu_torch.device import parity_numerics
    from coin_tpu_torch.kernels.deform_conv import deform_conv_cuda
    from coin_tpu_torch.models import glip
    F = torch.nn.functional
    parity_numerics()
    c = 256
    kernel = (torch.randn((3, 3, c, c), generator=gen) / 48).to(dev)
    bias = (torch.randn(c, generator=gen) * 0.1).to(dev)
    dense_w = kernel.permute(3, 2, 0, 1).contiguous()
    cases, worst = [], 0.0
    for label, (h, w), stride, per_block in _deform_calls():
        ho, wo = -(-h // stride), -(-w // stride)
        x = torch.randn((4, h, w, c), generator=gen).to(dev)
        offsets = (torch.rand((4, ho, wo, 18), generator=gen) * 6
                   - 3).to(dev)
        mask = torch.sigmoid(torch.randn((4, ho, wo, 9),
                                         generator=gen)).to(dev)
        got = deform_conv_cuda(x, offsets, mask, kernel, bias, stride)
        want = glip.deform_conv3x3_plain(x, offsets, mask, kernel, bias,
                                         stride)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        check(err <= 1e-5 * scale, f"deform_conv {label}: max abs err {err} "
              f"> 1e-5 x max |out| {scale}")
        worst = max(worst, err)
        ms = time_ms(torch, lambda: deform_conv_cuda(x, offsets, mask, kernel,
                                                     bias, stride))
        plain_ms = time_ms(torch, lambda: glip.deform_conv3x3_plain(
            x, offsets, mask, kernel, bias, stride), iters=3, warmup=1)
        xn = x.permute(0, 3, 1, 2)
        dense_ms = time_ms(torch, lambda: F.conv2d(xn, dense_w, bias,
                                                   stride=stride, padding=1))
        positions = 4 * ho * wo
        nbytes = 4 * (x.numel() + offsets.numel() + mask.numel()
                      + kernel.numel() + c + positions * c)
        b_ms, b_by = bound(nbytes, 2 * 9 * c * c * positions)
        cases.append(dict(case=label, per_block=per_block, x=[4, h, w, c],
                          out=[4, ho, wo, c], max_abs_err=err,
                          max_abs_out=scale, ms=ms, plain_ms=plain_ms,
                          library_ms=None, dense_conv_ms=dense_ms,
                          bound_ms=b_ms, bound_by=b_by))
        print(f"[K8 deform_conv] {label}: {positions} positions "
              f"(x{per_block} per block): max abs err {err:.3g} of max |out| "
              f"{scale:.3g} (tol 1e-5 x max |out|); {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); cuDNN dense "
              f"f32 3x3 conv of the same shape (not the same function) "
              f"{dense_ms:.4f} ms")
        del x, offsets, mask, got, want, xn
    torch.cuda.empty_cache()
    blocks = GLIP["blocks"]
    tot = {k: blocks * sum(cs[k] * cs["per_block"] for cs in cases)
           for k in ("ms", "plain_ms", "bound_ms", "dense_conv_ms")}
    by = max(cases, key=lambda cs: cs["bound_ms"] * cs["per_block"])[
        "bound_by"]
    launches = sum(cs["per_block"] for cs in cases) * blocks
    print(f"[K8 deform_conv] one GLIP-L forward ({launches} launches): "
          f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.3f} ms ({by}); library: none (dense cuDNN f32 "
          f"3x3 convs of the same shapes, as context: "
          f"{tot['dense_conv_ms']:.3f} ms)")
    return dict(name="deform_conv", route="cuda",
                source="coin_tpu_torch/csrc/deform_conv.cu",
                replaces="coin_tpu/models/glip.py:51", max_abs_err=worst,
                library_ms=None, bound_by=by, cases=cases, **tot)


def glip_checkpoint(torch):
    """A random GLIP-L checkpoint (Swin-L, 8 blocks, BERT-base with 30 522
    rows) in the official key layout of manifests.glip_manifest: N(0,
    0.02²) from a seeded generator, the norms' scales moved near 1 so that
    activations stay away from zero. Torch tensors, about 1.7 GB."""
    from coin_tpu_torch.models.manifests import glip_manifest
    keys, _ = glip_manifest(GLIP["variant"], GLIP["blocks"],
                            bert_layers=GLIP["bert_layers"],
                            bert_vocab=GLIP["bert_vocab"])
    gen = torch.Generator().manual_seed(SEED + 30)
    sd = {}
    for k, shape in keys.items():
        v = torch.randn(shape, generator=gen) * 0.02
        if len(shape) == 1 and not k.endswith(".bias") and (
                "norm" in k or "LayerNorm" in k or ".bn." in k):
            v = 1.0 + 5.0 * v
        sd[k] = v
    return sd


def phase_glip_reference(torch, dev, sd):
    """The full-width Swin-L GLIP (8 blocks) and BERT-base in f32 on the
    card (kernels) against the same weights on the CPU (plain versions),
    TF32 off, on 2 x 192 x 256: stage by stage, each stage from the CPU's
    output of the stage before, so that an error does not carry over;
    post-processing from the CPU's head outputs on both sides."""
    from coin_tpu_torch.data.augment import normalize_batch
    from coin_tpu_torch.device import parity_numerics
    from coin_tpu_torch.models.convert_gdino import bert_model
    from coin_tpu_torch.models.convert_glip import BERT_PREFIX, convert_glip
    from coin_tpu_torch.models.gdino_detector import (IMAGENET_MEAN,
                                                      IMAGENET_STD)
    from coin_tpu_torch.models.glip import GLIP as GLIPModel
    from coin_tpu_torch.models.glip_detector import (glip_anchors,
                                                     postprocess_glip)
    parity_numerics()
    params = convert_glip(sd, GLIP["variant"])
    gen = torch.Generator().manual_seed(SEED + 31)
    cells = torch.randint(0, 256, (2, 12, 16, 3), generator=gen,
                          dtype=torch.uint8)
    images_u8 = cells.repeat_interleave(16, 1).repeat_interleave(16, 2)
    ids = torch.randint(1000, 30000, (2, 14), generator=gen)
    tmask = torch.ones((2, 14), dtype=torch.bool)
    tmask[1, 11:] = False
    hw = torch.tensor([[192.0, 256.0], [192.0, 240.0]])
    pm = torch.zeros((8, 14))
    for cls in range(8):
        pm[cls, 1 + cls] = 1.0
    out, ref = {}, {}
    for name, d in (("cpu", "cpu"), ("gpu", dev)):
        model = GLIPModel(GLIP["variant"], GLIP["blocks"]).to(d)
        model.load_state_dict(params, strict=True)
        bert = bert_model(sd, BERT_PREFIX).to(d)
        t = lambda x: x.to(d)
        src = lambda key, x: x if name == "cpu" else \
            [v.to(d) for v in ref[key]] if isinstance(x, list) \
            else ref[key].to(d)
        o = {}
        with torch.inference_mode():
            o["bert"] = bert(t(ids), t(tmask))
            images = normalize_batch(t(images_u8), IMAGENET_MEAN,
                                     IMAGENET_STD)
            o["swin"] = model.backbone(images)
            o["fpn"] = model.fpn(src("swin", o["swin"]))
            levels, lang = src("fpn", o["fpn"]), src("bert", o["bert"])
            for i, blk in enumerate(model.blocks()):
                o[f"block{i}"], o[f"lang{i}"] = blk(levels, lang, t(tmask))
                levels = src(f"block{i}", o[f"block{i}"])
                lang = src(f"lang{i}", o[f"lang{i}"])
            o["head"] = list(model.head(levels, lang))
            shapes = [(f.shape[1], f.shape[2]) for f in levels]
            anchors = t(torch.from_numpy(glip_anchors(shapes)))
            det = postprocess_glip(*src("head", o["head"]), anchors, t(pm),
                                   t(hw), 8)
        o = {k: [x.cpu() for x in v] if isinstance(v, list) else v.cpu()
             for k, v in o.items()}
        o["det"] = det.map(lambda x: x.cpu())
        (ref if name == "cpu" else out).update(o)
        del model, bert
    torch.cuda.empty_cache()
    check(shapes == [(24, 32), (12, 16), (6, 8), (3, 4), (2, 2)],
          f"{shapes}")

    def rel(a, b):
        if isinstance(a, list):
            return max(rel(x, y) for x, y in zip(a, b))
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()
    errs = {k: rel(out[k], ref[k]) for k in ref if k != "det"}
    g, c = out["det"], ref["det"]
    same = (g.valid == c.valid) & (g.classes == c.classes) & (
        (g.boxes - c.boxes).abs().amax(-1) <= 1e-3)
    agree = same.float().mean().item()
    print(f"[GLIP reference] Swin-L GLIP (8 blocks) + BERT-base in f32, card "
          f"vs CPU, 2 x 192 x 256, 14 tokens (3 padded), each stage from the "
          f"CPU's input: relative max errors {json.dumps(errs)} (tol 1e-3); "
          f"post-processing of the CPU's head outputs: {int(c.valid.sum())} "
          f"detections on the CPU, rows that agree {agree:.4f}")
    check(all(v <= 1e-3 for v in errs.values()), f"GLIP reference: {errs}")
    check(agree >= 0.99 and int(c.valid.sum()) > 0,
          "GLIP reference: post-processing")


def phase_glip_collect_path(torch, dev, sd, counters):
    """The collection pass with the GLIP teacher: build_cloud_detector of
    configs/coin/GLIP/foggy.yaml's teacher (Swin-L, 8 VLDyHead blocks,
    BERT-base; bf16 over f32 parameters, DyConv in f32) from a checkpoint
    file in the official layout, then collect_cloud with CLOUD.NMS_METHOD
    'ms' over 8 synthetic 1024 x 2048 images (2 batches of 4 on
    608 x 1216); the npz saved, loaded and packed as the trainer reads it.
    K4n, K9, K8, K3 and K6 must launch."""
    import tempfile
    import numpy as np
    from coin_tpu_torch.config import load_config
    from coin_tpu_torch.data.augment import normalize_batch
    from coin_tpu_torch.data.loader import TestLoader, _resize_factor
    from coin_tpu_torch.data.voc import (CITYSCAPES_CLASSES,
                                         make_synthetic_voc,
                                         register_pascal_voc)
    from coin_tpu_torch.engine import collect as collect_mod
    from coin_tpu_torch.engine.cloud_factory import build_cloud_detector
    from coin_tpu_torch.engine.results_store import ResultStore
    from coin_tpu_torch.models.gdino_detector import (IMAGENET_MEAN,
                                                      IMAGENET_STD)
    n_images = 8
    tmp = tempfile.mkdtemp(prefix="chip_smoke_glip_")
    root = os.path.join(REPO, "output", "chip_smoke_collect_glip")
    shutil.rmtree(root, ignore_errors=True)
    try:
        ckpt = os.path.join(tmp, "glip_large_random.pth")
        t0 = time.perf_counter()
        torch.save({"model": sd}, ckpt)
        save_s = time.perf_counter() - t0
        vocab = os.path.join(tmp, "vocab.txt")
        _synthetic_vocab(vocab, CITYSCAPES_CLASSES)
        make_synthetic_voc(os.path.join(root, "foggy"), num_images=n_images,
                           class_names=CITYSCAPES_CLASSES,
                           image_hw=(1024, 2048), seed=SEED + 3,
                           split="train")
        register_pascal_voc("chip_smoke_collect_glip", "foggy", "train",
                            CITYSCAPES_CLASSES, ".jpg")
        cfg = load_config(os.path.join(REPO, "configs/coin/GLIP/foggy.yaml"))
        cfg.MODEL.TEACHER_CLOUD.WEIGHT = ckpt
        cfg.TPU.BERT_VOCAB = vocab
        tc, ctc = cfg.MODEL.TEACHER_CLOUD, cfg.CLOUD.TEACHER_CLOUD
        itc = cfg.INPUT.TEACHER_CLOUD
        check((tc.META_ARCHITECTURE, tc.TYPE, tc.TEST_THRESHOLD,
               cfg.CLOUD.NMS_METHOD, ctc.COLLECT_NMS_THRESH,
               ctc.RCNN_THRESH, itc.MIN_SIZE_TEST)
              == ("GLIP", GLIP["variant"], 0.25, "ms", 0.6, 0.25, 600),
              "not configs/coin/GLIP/foggy.yaml's cloud teacher")
        t0 = time.perf_counter()
        det = build_cloud_detector(cfg, tc.META_ARCHITECTURE,
                                   CITYSCAPES_CLASSES, device=dev)
        build_s = time.perf_counter() - t0
        model = det.model
        check(model.dtype == torch.bfloat16
              and model.num_blocks == GLIP["blocks"]
              and model.variant == GLIP["variant"]
              and all(p.dtype == torch.float32 for p in model.parameters())
              and det.bert.config.num_hidden_layers == GLIP["bert_layers"]
              and det.bert.config.vocab_size == GLIP["bert_vocab"]
              and det.capacity == 256,
              "not the full-width Swin-L GLIP with BERT-base")
        n_params = sum(p.numel() for p in model.parameters()) + sum(
            p.numel() for p in det.bert.parameters())
        loader = TestLoader("chip_smoke_collect_glip", root, batch_size=4,
                            min_size=itc.MIN_SIZE_TEST,
                            max_size=itc.get("MAX_SIZE_TEST", 1333))
        check(tuple(loader.canvas_hw) == (608, 1216), f"{loader.canvas_hw}")
        kw = dict(nms_method=cfg.CLOUD.NMS_METHOD,
                  collect_nms_thresh=ctc.COLLECT_NMS_THRESH,
                  rcnn_thresh=ctc.RCNN_THRESH,
                  rpn_thresh=(ctc.RPN_THRESH if ctc.RPN_SEPARATE_COLLECT
                              else ctc.RCNN_THRESH), device=dev)
        collect_mod.collect_cloud(det, loader, 8, **kw)        # warm-up
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store = collect_mod.collect_cloud(det, loader, 8, **kw)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        mem = torch.cuda.max_memory_allocated() / 2 ** 30

        npz = os.path.join(root, "GLIP_collect.npz")
        store.save(npz)
        back = ResultStore.load(npz)
        ids = [r["image_id"] for r in loader.records]
        check(sorted(back.image_ids()) == sorted(ids), "store image ids")
        counts = {"RCNN": [], "RPN": []}
        for rec in loader.records:
            for view in counts:
                v = back.get_view(rec["image_id"], view)
                n = len(v["scores"])
                counts[view].append(n)
                check(v["probs"].shape == (n, 9) and bool(np.isfinite(
                    v["boxes"]).all()) and bool((v["scores"] >= 0.25).all())
                      and bool((v["scores"] <= 1.0).all()),
                      f"store view {view} of {rec['image_id']}")
                scale = _resize_factor(rec["height"], rec["width"],
                                       loader.min_size, loader.max_size)
                packed = back.pack_view(rec["image_id"], view, 128, scale,
                                        False, float(loader.canvas_hw[1]))
                check(int(packed["valid"].sum()) == min(n, 128),
                      "pack_view")
        check(sum(counts["RCNN"]) > 0, "the collection stored nothing")

        # one batch on the device: the whole call, then stage by stage
        fusion = collect_mod.parse_nms_method(cfg.CLOUD.NMS_METHOD)
        batch, _ = next(iter(loader))
        u8 = torch.from_numpy(batch.images).to(dev)
        hw = torch.from_numpy(batch.image_hw).to(dev)
        b = u8.shape[0]
        names = ("normalize_and_swin", "fpn", "vlfuse", "language_layer",
                 "dyconv", "head_postprocess_and_fusion_nms")
        with torch.inference_mode():
            batch_ms = time_ms(torch, lambda: collect_mod.postprocess(
                det(u8, hw), fusion, 0.6), iters=5, warmup=1)
            emb = det.embeds.expand(b, -1, -1)
            tmask = det.text_mask.expand(b, -1)
            splits = []
            for _ in range(4):
                ms = dict.fromkeys(names, 0.0)
                ev = lambda: torch.cuda.Event(enable_timing=True)
                marks = [ev()]
                marks[0].record()

                def mark(name):
                    e = ev()
                    e.record()
                    marks.append((name, e))
                images = normalize_batch(u8, IMAGENET_MEAN, IMAGENET_STD)
                feats = model.backbone(images.to(model.dtype))
                mark("normalize_and_swin")
                levels = model.fpn(feats)
                mark("fpn")
                lang = emb
                for blk in model.blocks():
                    levels, lang = blk.fuse(levels, lang, tmask)
                    mark("vlfuse")
                    lang = blk.language(lang, tmask)
                    mark("language_layer")
                    levels = blk.dyconv(levels)
                    mark("dyconv")
                shapes = [(f.shape[1], f.shape[2]) for f in levels]
                raw = det.postprocess(*model.head(levels, lang), shapes, hw)
                fused = collect_mod.postprocess(raw, fusion, 0.6)
                mark("head_postprocess_and_fusion_nms")
                torch.cuda.synchronize()
                prev = marks[0]
                for name, e in marks[1:]:
                    ms[name] += prev.elapsed_time(e)
                    prev = e
                splits.append(ms)
        stage_ms = {n: statistics.median(s[n] for s in splits[1:])
                    for n in names}
        check(shapes == [tuple(s) for s in GLIP_LEVELS],
              f"feature levels {shapes}")
        before = raw.valid.sum(-1).tolist()
        after = fused.valid.sum(-1).tolist()
        print(f"[collect GLIP] build_cloud_detector(GLIP/foggy.yaml, 'GLIP') "
              f"from a {os.path.getsize(ckpt) / 2 ** 30:.2f} GiB checkpoint "
              f"({n_params / 1e6:.1f} M parameters; written in {save_s:.1f} "
              f"s) in {build_s:.1f} s; collect_cloud over {n_images} images "
              f"(2 batches of 4 on 608 x 1216, NMS_METHOD ms): {run_s:.3f} s,"
              f" {run_s * 1e3 / n_images:.2f} ms per image with host decode; "
              f"device {batch_ms:.3f} ms per batch of 4 "
              f"({batch_ms / 4:.3f} ms per image); peak device memory "
              f"{mem:.2f} GiB; kernel launches {json.dumps(launches)}")
        print(f"[collect GLIP] one batch by stage, ms (median of 3 after a "
              f"warm-up, CUDA events; the 8 blocks summed by part): "
              f"{json.dumps(stage_ms)}; detections per image before fusion "
              f"NMS {before}, after {after}; stored per image RCNN "
              f"{counts['RCNN']}, RPN {counts['RPN']}")
        check(all(v > 0 for v in launches.values()),
              f"a kernel was not launched on the GLIP collection path: "
              f"{launches}")
        check(launches["deform_conv_cuda"] == 13 * GLIP["blocks"] * 2,
              f"K8 launches {launches['deform_conv_cuda']}: expected 104 per "
              "forward, 2 batches")
        return launches, dict(ms_per_image=run_s * 1e3 / n_images,
                              batch_ms=batch_ms, stage_ms=stage_ms,
                              peak_gib=mem)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------ K10: image preprocessing
RESIZE_KERNELS = ("resize_weights", "resize_rows", "resize_cols")


def phase_resize(torch, dev, gen):
    """K10a against its dense plain version at the path shape (one 1024 x
    2048 u8 Foggy Cityscapes image at scale 600/1024 into the 608 x 1216
    canvas), at an upscale of 1.5 (400 x 800 f32) and at f32(0.305), where
    100 x scale is an f32 tie that rounds half to even (30 rows, not 31).
    Tolerance 1e-5 relative and 1e-3 absolute (0-255 units); the zeros
    past the scaled extent equal. The library call, F.interpolate's
    antialiased bilinear of the NCHW f32 image to 600 x 1200, is timed and
    compared on the interior and at the borders, where they may differ by
    design (JAX clamps the sample position, PyTorch clips the window).
    Times are device times from the profiler (``device_ms``): one wrapper
    call is three kernels and lasts less than its host launch."""
    import numpy as np
    import torch.nn.functional as F
    from coin_tpu_torch.kernels.preprocess import resize_bilinear_cuda
    from coin_tpu_torch.ops.preprocess import (resize_bilinear_plain,
                                               scaled_extent)
    from coin_tpu_torch.tools.bench_preprocess import FOGGY_HW, FOGGY_SCALE
    tie = float(np.float32(0.305))
    cases = (("foggy", FOGGY_HW, FOGGY_SCALE, (608, 1216), torch.uint8),
             ("up1.5", (400, 800), 1.5, (608, 1216), torch.float32),
             ("f32-tie", (100, 150), tie, (32, 48), torch.uint8))
    errs, images = {}, {}
    for name, hw, scale, out_hw, dtype in cases:
        img = (torch.rand(hw + (3,), generator=gen) * 255.999).to(dtype)
        img = img.to(dev)
        images[name] = img
        got = resize_bilinear_cuda(img, scale, out_hw)
        want = resize_bilinear_plain(img, scale, out_hw)
        err = (got - want).abs().max().item()
        errs[name] = err
        tol = 1e-3 + 1e-5 * want.abs().max().item()
        check(err <= tol, f"resize_bilinear {name}: max abs err {err} > {tol}")
        check(torch.equal(got == 0, want == 0),
              f"resize_bilinear {name}: zero region differs")
        if name == "f32-tie":
            check(scaled_extent(hw[0], scale) == 30
                  and bool((got[30:] == 0).all())
                  and bool((got[29] != 0).any()),
                  "resize_bilinear: the f32 tie did not round to 30 rows")
    img = images["foggy"]
    call = lambda: resize_bilinear_cuda(img, FOGGY_SCALE, (608, 1216))
    ms, per_call = device_ms(torch, call, RESIZE_KERNELS)
    check(per_call == 3, f"resize_bilinear: {per_call} kernels per call (3)")
    call_ms = time_ms(torch, call)
    plain_ms, _ = device_ms(torch, lambda: resize_bilinear_plain(
        img, FOGGY_SCALE, (608, 1216)), iters=5, warmup=1)
    nchw = img.permute(2, 0, 1)[None].float()
    lib = lambda: F.interpolate(nchw, size=(600, 1200), mode="bilinear",
                                antialias=True, align_corners=False)
    lib_ms, _ = device_ms(torch, lib)
    ours = call()[:600, :1200].permute(2, 0, 1)[None]
    diff = (lib() - ours).abs()
    interior = diff[..., 2:-2, 2:-2].max().item()
    border = diff.max().item()
    n_in, n_out = img.numel(), 608 * 1216 * 3 * 4
    b_ms, b_by = bound(n_in + n_out, 0)
    print(f"[K10a resize_bilinear] 1024 x 2048 u8 -> 608 x 1216 f32 at "
          f"600/1024: max abs err vs plain {json.dumps(errs)} (tol 1e-3 + "
          f"1e-5 of the largest value); device {ms:.4f} ms in 3 kernels "
          f"(profiler; events around each wrapper call {call_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms (dense matrices), F.interpolate "
          f"antialiased {lib_ms:.4f} ms (differs from K10a by "
          f"{interior:.4g} in the interior, {border:.4g} at the borders), "
          f"bound {b_ms:.5f} ms ({b_by})")
    return dict(name="resize_bilinear", route="cuda",
                source="coin_tpu_torch/csrc/preprocess.cu",
                replaces="coin_tpu/ops/preprocess.py:44",
                max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                call_ms=call_ms,
                library_diff_interior=interior, library_diff_border=border)


def phase_normalize_flip(torch, dev, gen):
    """K10b bit for bit against its plain version on the bench's batch (3
    x 608 x 1216 u8, flags mixed, tools/bench_preprocess.py's mean and
    std); no single PyTorch call computes it. Times are device times from
    the profiler (``device_ms``), as for K10a."""
    from coin_tpu_torch.kernels.preprocess import normalize_flip_cuda
    from coin_tpu_torch.ops.preprocess import normalize_flip_plain
    from coin_tpu_torch.tools.bench_preprocess import MEAN, STD
    images = torch.randint(0, 256, (3, 608, 1216, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    flags = torch.tensor([True, False, True], device=dev)
    got = normalize_flip_cuda(images, flags, MEAN, STD)
    want = normalize_flip_plain(images, flags, MEAN, STD)
    err = (got - want).abs().max().item()
    check(torch.equal(got, want), f"normalize_flip: not bit for bit "
          f"(max abs err {err})")
    for f in ([True] * 3, [False] * 3):
        fl = torch.tensor(f, device=dev)
        check(torch.equal(normalize_flip_cuda(images, fl, MEAN, STD),
                          normalize_flip_plain(images, fl, MEAN, STD)),
              f"normalize_flip: flags {f}")
    call = lambda: normalize_flip_cuda(images, flags, MEAN, STD)
    ms, per_call = device_ms(torch, call)
    check(per_call == 1, f"normalize_flip: {per_call} kernels per call (1)")
    call_ms = time_ms(torch, call)
    plain_ms, _ = device_ms(torch, lambda: normalize_flip_plain(
        images, flags, MEAN, STD))
    n = images.numel()
    b_ms, b_by = bound(n + 4 * n, 0)
    print(f"[K10b normalize_flip] {tuple(images.shape)} u8, flags mixed, "
          f"all, none -> f32: bit for bit; device {ms:.4f} ms (profiler; "
          f"events around each wrapper call {call_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); no library "
          f"call")
    return dict(name="normalize_flip", route="cuda",
                source="coin_tpu_torch/csrc/preprocess.cu",
                replaces="coin_tpu/ops/preprocess.py:67", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, call_ms=call_ms)


def phase_bench_preprocess_path(torch, counters):
    """K10's main path: the port's tools/bench_preprocess through its
    ``main``, as a user runs it (batch 3, a few iterations). K10a and K10b
    must launch."""
    from coin_tpu_torch.tools import bench_preprocess
    for fn in counters:
        fn.launches = 0
    report = bench_preprocess.main(["--iters", "5"])
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"[bench_preprocess path] normalize_flip {report['jnp_ms']:.4f} "
          f"ms ({report['jnp_gbps']} GB/s), resize_bilinear "
          f"{report['resize_ms']:.4f} ms ({report['resize_gbps']} GB/s); "
          f"kernel launches {json.dumps(launches)}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the bench_preprocess path: "
          f"{launches}")
    return launches, report


# ------------------------------------------------ the CLIP re-scorer
def phase_clip_reference(torch, dev, ckpt):
    """The full-width CLIP RN50 scorer (backbone, K1 on res4, res5, the
    attention pool) and its 12-layer text trunk in f32 on the card
    (kernels) against the same weights on the CPU (plain versions), TF32
    off, on 2 x 128 x 192 with 8 boxes each and the 9 prompts of one
    template."""
    from coin_tpu_torch.data.augment import normalize_batch
    from coin_tpu_torch.device import parity_numerics
    from coin_tpu_torch.models import convert as C
    from coin_tpu_torch.models.clip_scorer import CLIPScorer
    from coin_tpu_torch.models.text_encoder import TextTransformer
    parity_numerics()
    sd = C.load_torch_state_dict(ckpt)
    backbone, res5, attnpool = C.convert_clip_visual(sd)
    geo = C.text_geometry(sd)
    check(geo == dict(width=512, heads=8, layers=12, embed_dim=1024,
                      vocab_size=49408, context_length=77),
          f"not CLIP RN50's text trunk: {geo}")
    text_sd = C.convert_clip_text(sd)
    gen = torch.Generator().manual_seed(SEED + 30)
    cells = torch.randint(0, 256, (2, 8, 12, 3), generator=gen,
                          dtype=torch.uint8)
    images_u8 = cells.repeat_interleave(16, 1).repeat_interleave(16, 2)
    boxes = random_boxes(torch, gen, (2, 8), (128, 192), 16.0, 96.0)
    tokens = torch.randint(1, 400, (9, 77), generator=gen)
    tokens[:, 12] = 49407                      # EOT, the largest id
    tokens[:, 13:] = 0
    out = {}
    for name, d in (("cpu", "cpu"), ("gpu", dev)):
        scorer = CLIPScorer(50).to(d)
        scorer.backbone.load_state_dict(backbone)
        scorer.res5.load_state_dict(res5)
        scorer.attnpool.load_state_dict(attnpool)
        trunk = TextTransformer(**geo).to(d)
        trunk.load_state_dict(text_sd)
        with torch.inference_mode():
            text = trunk(tokens.to(d))
            images = normalize_batch(images_u8.to(d))
            feats = scorer.backbone(images, torch.float32)
            probs = scorer(images, boxes.to(d), text, C.logit_scale_from(sd))
        out[name] = dict(text=text.cpu(), res4=feats.cpu(), probs=probs.cpu())
        del scorer, trunk
    torch.cuda.empty_cache()
    errs = {k: ((out["gpu"][k] - out["cpu"][k]).abs().max()
                / out["cpu"][k].abs().max()).item() for k in out["cpu"]}
    print(f"[CLIP reference] RN50 CLIPScorer + 12-layer text trunk in f32, "
          f"card vs CPU, 2 x 128 x 192, 8 boxes each, 9 prompts: relative "
          f"max errors {json.dumps(errs)} (tol 1e-3)")
    check(all(v <= 1e-3 for v in errs.values()), f"CLIP reference: {errs}")


def phase_clip_path(torch, dev, ckpt, bpe, cloud_store, counters):
    """The CLIP re-scoring pass (stage 1b) as tools/collect runs it without
    --skip-clip: build_clip_scorer of foggy_fast.yaml with TPU.CLIP_WEIGHTS
    (a random checkpoint in OpenAI CLIP RN50's layout) and
    TPU.CLIP_BPE_VOCAB (a merges file of the prompts' words) set in code,
    then rescore_with_clip over the GDINO collection phase's store of the
    same 12 synthetic 1024 x 2048 images (batches of 4 on 608 x 1216, both
    views, TPU.CAP_TEACHER boxes each); CLIP_collect.npz written and read
    back as the pre-train stage reads it. K1 and K4n must launch."""
    import numpy as np
    from coin_tpu_torch.config import load_config
    from coin_tpu_torch.data.loader import TestLoader
    from coin_tpu_torch.data.voc import (CITYSCAPES_CLASSES,
                                         make_synthetic_voc,
                                         register_pascal_voc)
    from coin_tpu_torch.engine import collect as collect_mod
    from coin_tpu_torch.engine.cloud_factory import build_clip_scorer
    from coin_tpu_torch.engine.results_store import ResultStore
    root = os.path.join(REPO, "output", "chip_smoke_clip")
    shutil.rmtree(root, ignore_errors=True)
    try:
        make_synthetic_voc(os.path.join(root, "foggy"), num_images=12,
                           class_names=CITYSCAPES_CLASSES,
                           image_hw=(1024, 2048), seed=SEED, split="train")
        register_pascal_voc("chip_smoke_clip", "foggy", "train",
                            CITYSCAPES_CLASSES, ".jpg")
        cfg = load_config(os.path.join(REPO,
                                       "configs/coin/GDINO/foggy_fast.yaml"))
        cfg.TPU.CLIP_WEIGHTS, cfg.TPU.CLIP_BPE_VOCAB = ckpt, bpe
        t0 = time.perf_counter()
        scorer = build_clip_scorer(cfg, CITYSCAPES_CLASSES, device=dev)
        build_s = time.perf_counter() - t0
        itc = cfg.INPUT.TEACHER_CLOUD
        loader = TestLoader("chip_smoke_clip", root, batch_size=4,
                            min_size=itc.MIN_SIZE_TEST,
                            max_size=itc.get("MAX_SIZE_TEST", 1333))
        ids = sorted(r["image_id"] for r in loader.records)
        check(sorted(cloud_store.image_ids()) == ids,
              "the GDINO store is not of the same images")
        cap = cfg.TPU.CAP_TEACHER
        collect_mod.rescore_with_clip(scorer, cloud_store, loader, cap,
                                      device=dev)            # warm-up
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = collect_mod.rescore_with_clip(scorer, cloud_store, loader, cap,
                                            device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        npz = os.path.join(root, "CLIP_collect.npz")
        out.save(npz)
        back = ResultStore.load(npz)
        check(sorted(back.image_ids()) == ids, "CLIP store image ids")
        before = after = 0
        for i in ids:
            for view in ("RCNN", "RPN"):
                v = back.get_view(i, view)
                n = len(v["scores"])
                after += n
                before += min(len(cloud_store.get_view(i, view)["scores"]),
                              cap)
                check(v["probs"].shape == (n, 9)
                      and bool(np.isfinite(v["probs"]).all())
                      and bool(np.isfinite(v["boxes"]).all())
                      and bool((v["classes"] < 8).all())
                      and bool((np.abs(v["probs"].sum(-1) - 1) < 1e-4).all())
                      and bool((v["scores"] == v["probs"].max(-1)).all()),
                      f"CLIP store view {view} of {i}")
        check(after > 0, "re-scoring kept no box")
        batch, _ = next(iter(loader))
        u8 = torch.from_numpy(batch.images).to(dev)
        boxes = torch.from_numpy(np.stack([cloud_store.pack_view(
            batch.image_ids[i], "RCNN", cap, float(batch.scale[i]), False,
            float(batch.image_hw[i][1]))["boxes"]
            for i in range(len(batch.image_ids))])).to(dev)
        with torch.inference_mode():
            batch_ms = time_ms(torch, lambda: scorer(u8, boxes), iters=10,
                               warmup=2)
        print(f"[CLIP path] build_clip_scorer(foggy_fast.yaml) from a "
              f"{os.path.getsize(ckpt) / 2 ** 30:.2f} GiB RN50 checkpoint "
              f"in {build_s:.1f} s; rescore_with_clip over 12 images (3 "
              f"batches of 4 on 608 x 1216, both views, {cap} boxes each): "
              f"{run_s:.3f} s, {run_s * 1e3 / 12:.2f} ms per image with "
              f"host decode; device {batch_ms:.3f} ms per scorer call (4 "
              f"images, one view); rows before {before}, after {after} "
              f"(background-classified boxes dropped); kernel launches "
              f"{json.dumps(launches)}")
        check(all(v > 0 for v in launches.values()),
              f"a kernel was not launched on the CLIP path: {launches}")
        return launches, dict(ms_per_image=run_s * 1e3 / 12,
                              call_ms=batch_ms, rows=(before, after))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "coin_tpu_torch")):
        print("chip_smoke: coin_tpu_torch/ is missing beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    dev = torch.device("cuda:0")
    print(f"[device] {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    from coin_tpu_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all(extra_flags=["-Xptxas", "-v"])
    print(f"[build] {len(logs)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    from coin_tpu_torch.kernels.augment import augment_cuda
    from coin_tpu_torch.kernels.deform_conv import deform_conv_cuda
    from coin_tpu_torch.kernels.fusion_nms import fusion_nms_cuda
    from coin_tpu_torch.kernels.ms_deform import ms_deform_cuda
    from coin_tpu_torch.kernels.nms import nms_sorted_cuda
    from coin_tpu_torch.kernels.normalize import normalize_cuda
    from coin_tpu_torch.kernels.preprocess import (normalize_flip_cuda,
                                                   resize_bilinear_cuda)
    from coin_tpu_torch.kernels.qconv import (int8_conv_cuda,
                                              qconv_dgrad_cuda,
                                              qconv_fwd_cuda,
                                              qconv_wgrad_cuda,
                                              quantize_cuda,
                                              quantize_weight_cuda,
                                              quantize_weight_pair_cuda)
    from coin_tpu_torch.kernels.roi_align import (
        roi_align_backward_cuda, roi_align_cuda, roi_align_int8_backward_cuda,
        roi_align_int8_cuda)
    from coin_tpu_torch.kernels.window_attention import window_attention_cuda
    quant = [quantize_cuda, quantize_weight_cuda]
    eval_counters = [roi_align_cuda, nms_sorted_cuda, normalize_cuda,
                     qconv_fwd_cuda] + quant
    train_counters = [roi_align_cuda, nms_sorted_cuda, normalize_cuda,
                      roi_align_backward_cuda, augment_cuda]
    trainer_counters = train_counters + quant + [
        quantize_weight_pair_cuda, qconv_fwd_cuda, qconv_dgrad_cuda,
        qconv_wgrad_cuda, int8_conv_cuda]
    roi_counters = trainer_counters + [roi_align_int8_cuda,
                                       roi_align_int8_backward_cuda]
    collect_counters = [normalize_cuda, window_attention_cuda,
                        ms_deform_cuda, fusion_nms_cuda]
    glip_counters = [normalize_cuda, window_attention_cuda, deform_conv_cuda,
                     nms_sorted_cuda, fusion_nms_cuda]
    preprocess_counters = [resize_bilinear_cuda, normalize_flip_cuda]
    clip_counters = [roi_align_cuda, normalize_cuda]
    gen = torch.Generator().manual_seed(SEED)
    with torch.inference_mode():
        kernels = [phase_roi_align(torch, dev, gen),
                   phase_roi_align_bwd(torch, dev, gen),
                   phase_roi_align_int8(torch, dev, gen),
                   phase_roi_align_int8_bwd(torch, dev, gen),
                   phase_self_cluster(torch, dev),
                   phase_nms(torch, dev, gen), phase_augment(torch, dev, gen),
                   phase_normalize(torch, dev, gen),
                   phase_quantize(torch, dev),
                   *phase_qconv(torch, dev),
                   phase_int8_conv(torch, dev),
                   phase_window_attention(torch, dev, gen),
                   phase_ms_deform(torch, dev, gen),
                   phase_fusion_nms(torch, dev, gen),
                   phase_deform_conv(torch, dev, gen),
                   phase_resize(torch, dev, gen),
                   phase_normalize_flip(torch, dev, gen)]
    torch.cuda.empty_cache()
    pre_launches, _ = phase_bench_preprocess_path(torch, preprocess_counters)
    from coin_tpu_torch.config import load_config
    from coin_tpu_torch.data.voc import CITYSCAPES_CLASSES
    from coin_tpu_torch.engine.common import simple_class_tokens
    cfg = load_config(os.path.join(REPO, "configs/coin/GDINO/foggy_fast.yaml"))
    num_classes = len(CITYSCAPES_CLASSES)
    tokens = simple_class_tokens(num_classes + 1)
    phase_reference(torch, dev, cfg, num_classes, tokens)
    phase_step_reference(torch, dev, num_classes, tokens)
    phase_step_reference(torch, dev, num_classes, tokens, int8=True)
    phase_step_reference(torch, dev, num_classes, tokens, int8=True,
                         int8_roi=True)
    eval_launches, _ = phase_main_path(torch, dev, cfg, num_classes, tokens,
                                       eval_counters)
    torch.cuda.empty_cache()
    train_launches, _ = phase_train_path(torch, dev, num_classes, tokens,
                                         train_counters)
    torch.cuda.empty_cache()
    from coin_tpu_torch.ops import roi_align as troi
    rec, restore = record_first_call(troi, "roi_align_backward")
    # K1's first call in a training step (the student's features take a
    # gradient), and the teacher's first over 512 proposals per image
    rec_fwd, restore_fwd = record_first_call(
        troi, "_forward", lambda f, rois: f.requires_grad)
    rec_teacher, restore_teacher = record_first_call(
        troi, "_forward", lambda f, rois: not f.requires_grad
        and rois.shape[1] == 512)
    try:
        trainer_launches, trainer = phase_trainer_path(
            torch, dev, num_classes, trainer_counters)
    finally:
        restore_teacher()
        restore_fwd()
        restore()
    torch.cuda.empty_cache()
    if "--save-rois" in sys.argv:
        # K1's recorded RoIs, for tools/kernel_turns --rois
        torch.save({label: r["rois"].cpu() for label, r in
                    (("trainer", rec_fwd), ("teacher", rec_teacher)) if r},
                   sys.argv[sys.argv.index("--save-rois") + 1])
    with torch.inference_mode():
        next(k for k in kernels if k["name"] == "roi_align_bwd").update(
            k1b_on_trainer_rois(torch, dev, rec))
        next(k for k in kernels if k["name"] == "roi_align_int8_bwd").update(
            k5b_on_trainer_rois(torch, dev, rec))
        k1 = next(k for k in kernels if k["name"] == "roi_align")
        k1.update(k1_on_recorded_rois(torch, dev, rec_fwd, "trainer",
                                      SEED + 14))
        k1.update(k1_on_recorded_rois(torch, dev, rec_teacher, "teacher",
                                      SEED + 15))
    del rec, rec_fwd, rec_teacher
    torch.cuda.empty_cache()
    roi_launches, _ = phase_int8_roi_trainer_path(torch, dev, num_classes,
                                                  roi_counters)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sd = gdino_checkpoint()
    print(f"[GDINO checkpoint] {len(sd)} tensors, "
          f"{sum(v.size for v in sd.values()) / 1e6:.1f} M values, drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    phase_gdino_reference(torch, dev, sd)
    collect_launches, collect_info = phase_collect_path(torch, dev, sd,
                                                        collect_counters)
    del sd
    torch.cuda.empty_cache()
    import tempfile
    from coin_tpu_torch.models.manifests import clip_assets
    tmp = tempfile.mkdtemp(prefix="chip_smoke_clip_")
    try:
        t0 = time.perf_counter()
        ckpt, bpe = clip_assets(tmp, CITYSCAPES_CLASSES,
                                cfg.DATASETS.STYLE_NAME or "realistic", SEED)
        print(f"[CLIP checkpoint] random RN50 in OpenAI's layout, "
              f"{os.path.getsize(ckpt) / 2 ** 30:.2f} GiB, drawn and written "
              f"in {time.perf_counter() - t0:.1f} s")
        phase_clip_reference(torch, dev, ckpt)
        clip_launches, _ = phase_clip_path(torch, dev, ckpt, bpe,
                                           collect_info.pop("store"),
                                           clip_counters)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sd = glip_checkpoint(torch)
    print(f"[GLIP checkpoint] {len(sd)} tensors, "
          f"{sum(v.numel() for v in sd.values()) / 1e6:.1f} M values, drawn "
          f"in {time.perf_counter() - t0:.1f} s")
    phase_glip_reference(torch, dev, sd)
    glip_launches, _ = phase_glip_collect_path(torch, dev, sd, glip_counters)
    del sd
    # the kernels line: launches are those of each kernel's main path (the
    # GDINO collection path for K6, K7 and K9, the GLIP collection path for
    # K8, the int8-RoI trainer path for K5 and K5b, the share-crops
    # collection pass for K11, the bench_preprocess path for K10a and
    # K10b, the trainer path for the rest); an entry of several wrappers
    # counts them all
    by_fn = {"roi_align": ["roi_align_cuda"],
             "roi_align_bwd": ["roi_align_backward_cuda"],
             "roi_align_int8": ["roi_align_int8_cuda"],
             "roi_align_int8_bwd": ["roi_align_int8_backward_cuda"],
             "self_cluster": ["self_cluster_cuda"],
             "nms": ["nms_sorted_cuda"], "augment": ["augment_cuda"],
             "normalize": ["normalize_cuda"],
             "quantize": ["quantize_cuda", "quantize_weight_cuda",
                          "quantize_weight_pair_cuda"],
             "qconv_fwd": ["qconv_fwd_cuda"],
             "qconv_dgrad": ["qconv_dgrad_cuda"],
             "qconv_wgrad": ["qconv_wgrad_cuda"],
             "int8_conv": ["int8_conv_cuda"],
             "window_attention": ["window_attention_cuda"],
             "ms_deform": ["ms_deform_cuda"],
             "fusion_nms": ["fusion_nms_cuda"],
             "deform_conv": ["deform_conv_cuda"],
             "resize_bilinear": ["resize_bilinear_cuda"],
             "normalize_flip": ["normalize_flip_cuda"]}
    paths = {"trainer": trainer_launches, "training": train_launches,
             "eval": eval_launches, "collect": collect_launches,
             "collect_glip": glip_launches, "int8_roi_trainer": roi_launches,
             "share_crops": trainer["share_launches"],
             "bench_preprocess": pre_launches, "clip_rescore": clip_launches}
    main_paths = {"window_attention": "collect", "ms_deform": "collect",
                  "fusion_nms": "collect", "deform_conv": "collect_glip",
                  "roi_align_int8": "int8_roi_trainer",
                  "roi_align_int8_bwd": "int8_roi_trainer",
                  "self_cluster": "share_crops",
                  "resize_bilinear": "bench_preprocess",
                  "normalize_flip": "bench_preprocess"}
    for k in kernels:
        fns = by_fn[k["name"]]
        main_path = main_paths.get(k["name"], "trainer")
        k["launches"] = sum(paths[main_path][f] for f in fns)
        k["launches_by_path"] = {p: sum(n.get(f, 0) for f in fns)
                                 for p, n in paths.items()}
    print(f"[wall] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
