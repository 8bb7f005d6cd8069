#!/usr/bin/env python3
"""Smoke run of coin_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. device: CUDA is required (there is no CPU path); prints the card's name
   and power limit as nvidia-smi reports them.
2. build: compiles every kernel of the inference slice from
   coin_tpu_torch/csrc with nvcc (one process per source, all at once).
3. kernels: each kernel against its plain PyTorch version on the same card
   inputs at the shapes of the main path (foggy_fast: 4 images on a
   608 x 1216 canvas, 6000/1000 RPN boxes, 1024 box-head candidates),
   with its median time, the plain version's and the card's bound.
4. reference: the full-width detector in f32 on the card against the same
   weights on the CPU (plain versions throughout) on a small canvas.
5. main path: evaluate_detector of the full-width CLIP-RN50
   OpenVocabularyRCNN (bf16, random weights from a seed) over a synthetic
   8-image Foggy-Cityscapes-classed VOC set read through
   configs/coin/GDINO/foggy_fast.yaml; every kernel's launch count must
   rise on this path.

The second-to-last line is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or coin_tpu.
"""

from __future__ import annotations

import json
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


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def bound(nbytes: float, flops: float):
    """Least time on the card (ms) and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
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
                replaces="coin_tpu/ops/roi_align.py:53",
                max_abs_err=max(err.max().item(), e32), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def _nms_case(torch, dev, gen, label, n, thr, classes, hw, max_wh):
    from coin_tpu_torch.kernels.nms import nms_sorted_cuda
    from coin_tpu_torch.ops import nms as nms_ops
    boxes = random_boxes(torch, gen, (4, n), hw, 4.0, max_wh).to(dev)
    scores = torch.rand((4, n), generator=gen).to(dev)
    valid = (torch.rand((4, n), generator=gen) < 0.95).to(dev)
    cls = (torch.randint(0, 8, (4, n), generator=gen).to(dev)
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
    pairs = sum(c * (c - 1) / 2 for c in counts.tolist())
    b_ms, b_by = bound(sboxes.numel() * 4 + 16 + 4 * n, pairs * 15)
    print(f"[K3 nms {label}] 4 x {n} boxes, IoU {thr}, class-aware "
          f"{classes}: keep masks identical ({int(want.sum())} kept); "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
          f"({b_by})")
    return dict(case=label, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def phase_nms(torch, dev, gen):
    rpn = _nms_case(torch, dev, gen, "rpn", 6000, 0.7, False, (608, 1216),
                    300.0)
    box = _nms_case(torch, dev, gen, "box_head", 1024, 0.5, True,
                    (608, 1216), 200.0)
    return dict(name="nms", route="cuda", source="coin_tpu_torch/csrc/nms.cu",
                replaces="coin_tpu/ops/nms.py:110", max_abs_err=0.0,
                ms=rpn["ms"], plain_ms=rpn["plain_ms"],
                bound_ms=rpn["bound_ms"], bound_by=rpn["bound_by"],
                library_ms=None, cases=[rpn, box])


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
                replaces="coin_tpu/data/augment.py:122", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


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
        check(next(model.backbone.parameters()).dtype == torch.bfloat16
              and model.text_trunk.layers == 12
              and model.text_trunk.ln_final.normalized_shape == (512,),
              "not the full-width bf16 RN50 detector")
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


def main() -> int:
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

    from coin_tpu_torch.kernels.nms import nms_sorted_cuda
    from coin_tpu_torch.kernels.normalize import normalize_cuda
    from coin_tpu_torch.kernels.roi_align import roi_align_cuda
    counters = [roi_align_cuda, nms_sorted_cuda, normalize_cuda]
    gen = torch.Generator().manual_seed(SEED)
    with torch.inference_mode():
        kernels = [phase_roi_align(torch, dev, gen), phase_nms(torch, dev, gen),
                   phase_normalize(torch, dev, gen)]
    from coin_tpu_torch.config import load_config
    from coin_tpu_torch.data.voc import CITYSCAPES_CLASSES
    from coin_tpu_torch.engine.common import simple_class_tokens
    cfg = load_config(os.path.join(REPO, "configs/coin/GDINO/foggy_fast.yaml"))
    num_classes = len(CITYSCAPES_CLASSES)
    tokens = simple_class_tokens(num_classes + 1)
    phase_reference(torch, dev, cfg, num_classes, tokens)
    launches, _ = phase_main_path(torch, dev, cfg, num_classes, tokens,
                                  counters)
    by_fn = {"roi_align": "roi_align_cuda", "nms": "nms_sorted_cuda",
             "normalize": "normalize_cuda"}
    for k in kernels:
        k["launches"] = launches[by_fn[k["name"]]]
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
