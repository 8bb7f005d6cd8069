"""Paired-seed AP A/B harness on synthetic VOC (counterpart of
tools/validate_cached_teacher.py, with its flags, modes, fixtures,
pre-registered exclusion rule and artifact keys).

Each seed pre-trains CLIPDET (``PRETrainer``) on a synthetic cloud store,
then trains two ``CoinTrainer`` arms from that checkpoint with the same
seed and data order, the base recipe and a variant, and records the AP50
of every eval. The aggregate is the mean per-seed delta over the
functional seeds (pre-train AP50 >= 10) with a 95 % t-interval; on
fixture v3 the primary endpoint is the mean AP50 of the last 3 evals.
``tools/ab_aggregate.py`` reads its artifacts.

    python -m coin_tpu_torch.tools.validate --mode shipped_i8 --seeds 4 \\
        --out output/ab_shipped_i8_v3_s4.json [--device cpu]

A campaign split over several runs: ``--seed-start 2 --resume-from
<the first run's artifact or its .partial>`` runs seeds 2.. and merges
the earlier ones. The modes are those of the JAX harness (see ``main``
and ``std_var``); ``--multi`` sweeps several standard-base modes over
shared seeds. Runs on the card unless ``--device cpu``. The fixture's
data and store come from numpy seeds, so they are the JAX harness's; the
weights and the on-device draws are torch's.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

# two-sided 95% t critical values, df = n-1
_T95 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
        7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228, 11: 2.201, 12: 2.179,
        13: 2.160, 14: 2.145, 15: 2.131}

EXCLUDE_PRETRAIN_AP_BELOW = 10.0  # pre-registered exclusion rule

# Modes whose base arm is the standard cached fp recipe (cache=True, the
# pre-train weights): exactly these can share one base run (and one
# pre-train) per seed in --multi sweeps.
STD_BASE_MODES = ("aa", "roibatch", "roibatch75", "int8train",
                  "int8train_wx", "int8train_ps", "int8train_fo",
                  "int8train_ps_roi", "batch")

MODES = ("aa", "cache", "fasthead", "roibatch", "budget", "batch",
         "batch_live", "refresh", "refresh_int8", "roibatch75",
         "int8train", "int8train_wx", "int8train_ps", "int8train_fo",
         "int8train_ps_roi", "shipped", "shipped_i8")


def build_cfg(root, out, iters, eval_every, batch=2, base_lr=0.02,
              fixture="v2"):
    from coin_tpu_torch.config import load_config
    cfg = load_config()
    if fixture == "v3":
        # anchors matched to the v3 object scales (12-56 px on the
        # 120 x 160 canvas, about 10-45 px after the 0.8 resize)
        cfg.MODEL.ANCHOR_GENERATOR.SIZES = [8, 16, 32, 64]
    cfg.DATASETS.ROOT = root
    cfg.DATASETS.TRAIN_UNLABEL = ["abtrain"]
    cfg.DATASETS.TEST = ["abval"]
    cfg.OUTPUT_DIR = out
    cfg.SOLVER.IMG_PER_BATCH_UNLABEL = batch
    cfg.SOLVER.MAX_ITER = iters
    cfg.SOLVER.BASE_LR = base_lr
    cfg.SOLVER.WARMUP_ITERS = 50
    cfg.SOLVER.STEPS = [10 ** 9]
    cfg.SOLVER.FACTOR_LIST = [1, 0.1]
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 ** 9
    cfg.TEST.EVAL_PERIOD = eval_every
    cfg.TEST.DETECTIONS_PER_IMAGE = 16
    cfg.INPUT.MIN_SIZE_TRAIN = 96
    cfg.INPUT.MIN_SIZE_TEST = 96
    cfg.INPUT.MAX_SIZE = 128
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 256
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 256
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 64
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.MERGE_DIM = 1024
    cfg.TPU.TEXT_LAYERS = 2
    cfg.TPU.TEXT_WIDTH = 64
    cfg.TPU.TEXT_HEADS = 2
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.CAP_TEACHER = 16
    cfg.TPU.CAP_C = 16
    # all iterations before burn-up: the cache only ever serves step_one
    cfg.CLOUD.BURN_UP_STEP = iters + 1
    cfg.CLOUD.PROTOTYPE_UPDATE_START = 50
    return cfg


def synth_store(records, num_classes, seed=3):
    """A cloud store of the ground truth jittered by up to 3 px, each box
    scored 0.5-0.95 on its class, from ``RandomState(seed)``."""
    from coin_tpu_torch.engine.results_store import ResultStore
    rng = np.random.RandomState(seed)
    store = ResultStore(num_classes)
    for rec in records:
        boxes = rec["boxes"] + rng.uniform(-3, 3, rec["boxes"].shape)
        n = len(boxes)
        probs = np.full((n, num_classes + 1), 0.04, np.float32)
        scores = rng.uniform(0.5, 0.95, n).astype(np.float32)
        for i, c in enumerate(rec["classes"]):
            probs[i, c] = scores[i]
        probs /= probs.sum(1, keepdims=True)
        for view in ("RCNN", "RPN"):
            store.put(rec["image_id"], view, boxes, rec["classes"],
                      probs.max(1), probs)
    return store


def pretrain(cfg, store, iters, device="cuda"):
    """Stage-2 CLIPDET pre-train on the synthetic store, so that the
    adaptation arms start from a working offline teacher; returns its
    checkpoint (``pre_train_CLIP_<iters>``) and AP50."""
    from coin_tpu_torch.engine.pre_train import PRETrainer
    cfg = cfg.clone()
    cfg.SOLVER.MAX_ITER = iters
    tr = PRETrainer(cfg, store=store, device=device)
    tr.train()
    ap = tr.test()["AP50"]
    ckpt = os.path.join(cfg.OUTPUT_DIR, "checkpoints",
                        f"pre_train_CLIP_{iters:07d}")
    return ckpt, ap


def run_one(cfg, store, cache: bool, weights: str = "",
            perturb: bool = False, device="cuda"):
    """One adaptation arm: ``CoinTrainer`` from ``weights``; returns the
    student's AP50 by eval step and the training seconds."""
    from coin_tpu_torch.engine.trainer import CoinTrainer
    cfg = cfg.clone()
    cfg.TPU.CACHE_TEACHER = bool(cache)
    cfg.TPU.CACHE_TEACHER_MIN_STEPS = 1
    if weights:
        cfg.MODEL.WEIGHTS = weights
    tr = CoinTrainer(cfg, store=store, device=device)
    tr.resume_or_load(False)
    if perturb:
        perturb_state(tr.state, cfg.SEED + 777)
    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)
    t0 = time.perf_counter()
    tr.train()
    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)
    dt = time.perf_counter() - t0
    return {str(k): v for k, v in tr.ap_50_student.items()}, dt


@torch.no_grad()
def perturb_state(state, seed: int) -> None:
    """The A/A variant arm: every float tensor of the student (parameters
    and FrozenBN statistics, which flax keeps as parameters) times
    1 + 1e-6 N(0, 1), drawn from ``torch.Generator(seed)`` on the CPU;
    the teacher a copy of the perturbed student."""
    gen = torch.Generator().manual_seed(seed)
    for t in state.model.state_dict().values():
        if t.is_floating_point():
            noise = torch.randn(t.shape, generator=gen, dtype=t.dtype)
            t.mul_(1 + 1e-6 * noise.to(t.device))
    state.teacher.load_state_dict(state.model.state_dict())


def std_var(mode, cfg_base, cfg_var, args, root):
    """Arm names and the variant arm's runner of a standard-base mode (the
    knob semantics, defined once for the single-mode path and --multi):
      aa               identical recipe, init perturbed 1e-6 (noise floor)
      roibatch         student ROI batch halved
      roibatch75       student ROI batch x 0.75
      int8train        TPU.INT8_TRAIN, int8 forward, dgrad and wgrad
      int8train_wx     int8 forward and dgrad, exact wgrad
      int8train_ps     per-sample scales (INT8_TRAIN_SCALE sample), exact
                       wgrad
      int8train_fo     int8 per-sample forward only (INT8_TRAIN_DGRAD off)
      int8train_ps_roi the ps recipe plus the int8 RoIAlign (TPU.INT8_ROI)
      batch            batch doubled, linear LR, half the iterations
    """
    run = lambda c, **kw: (lambda store, ckpt: run_one(
        c, store, cache=True, weights=ckpt, device=args.device, **kw))
    if mode == "aa":
        return ("aa_base", "aa_perturbed"), run(cfg_var, perturb=True)
    if mode == "roibatch":
        cfg_var.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE //= 2
        names = ("roi_full", "roi_half")
    elif mode == "roibatch75":
        cfg_var.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = (
            cfg_var.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE * 3) // 4
        names = ("roi_full", "roi_75")
    elif mode == "int8train":
        cfg_var.TPU.INT8_TRAIN = True
        names = ("fp_train", "int8_train")
    elif mode == "int8train_wx":
        cfg_var.TPU.INT8_TRAIN = True
        cfg_var.TPU.INT8_TRAIN_WGRAD = False
        names = ("fp_train", "int8wx_train")
    elif mode == "int8train_ps":
        cfg_var.TPU.INT8_TRAIN = True
        cfg_var.TPU.INT8_TRAIN_WGRAD = False
        cfg_var.TPU.INT8_TRAIN_SCALE = "sample"
        names = ("fp_train", "int8ps_train")
    elif mode == "int8train_ps_roi":
        cfg_var.TPU.INT8_TRAIN = True
        cfg_var.TPU.INT8_TRAIN_WGRAD = False
        cfg_var.TPU.INT8_TRAIN_SCALE = "sample"
        cfg_var.TPU.INT8_ROI = True
        names = ("fp_train", "int8psroi_train")
    elif mode == "int8train_fo":
        cfg_var.TPU.INT8_TRAIN = True
        cfg_var.TPU.INT8_TRAIN_WGRAD = False
        cfg_var.TPU.INT8_TRAIN_SCALE = "sample"
        cfg_var.TPU.INT8_TRAIN_DGRAD = False
        names = ("fp_train", "int8fo_train")
    elif mode == "batch":
        return ("batch_base", "batch_double"), run(
            _double_batch(cfg_base, cfg_var, args, root))
    else:
        raise ValueError(f"not a standard-base mode: {mode}")
    return names, run(cfg_var)


def _double_batch(cfg_base, cfg_var, args, root):
    """The batch modes' variant: twice the batch and the LR, half the
    iterations, eval period and warm-up."""
    cfg = build_cfg(root, cfg_var.OUTPUT_DIR, args.iters // 2,
                    max(args.eval_every // 2, 1),
                    batch=2 * cfg_base.SOLVER.IMG_PER_BATCH_UNLABEL,
                    base_lr=2 * cfg_base.SOLVER.BASE_LR,
                    fixture=args.fixture)
    cfg.SEED = cfg_var.SEED
    cfg.SOLVER.WARMUP_ITERS = cfg_base.SOLVER.WARMUP_ITERS // 2
    return cfg


def run_seed(args, root, store, seed_idx):
    """Pre-train, then both arms of ``args.mode`` for one seed (SEED =
    2024 + 101 seed_idx); its directories are removed after."""
    dirs = [tempfile.mkdtemp(prefix=p)
            for p in ("ab_pre_", "ab_base_", "ab_var_")]
    try:
        cfg_pre = build_cfg(root, dirs[0], args.pre_iters, 10 ** 9,
                            fixture=args.fixture)
        cfg_base = build_cfg(root, dirs[1], args.iters, args.eval_every,
                             fixture=args.fixture)
        cfg_var = build_cfg(root, dirs[2], args.iters, args.eval_every,
                            fixture=args.fixture)
        for c in (cfg_pre, cfg_base, cfg_var):
            c.SEED = 2024 + 101 * seed_idx
        dev = args.device
        ckpt, pre_ap = pretrain(cfg_pre, store, args.pre_iters, dev)
        print(f"[seed {seed_idx}] pretrain AP50 = {pre_ap:.2f}", flush=True)
        live = lambda c: run_one(c, store, cache=False, weights=ckpt,
                                 device=dev)
        mode = args.mode
        if mode in STD_BASE_MODES:
            names, runner = std_var(mode, cfg_base, cfg_var, args, root)
            base_ap, base_t = run_one(cfg_base, store, cache=True,
                                      weights=ckpt, device=dev)
            var_ap, var_t = runner(store, ckpt)
        elif mode == "cache":   # cached vs live teacher, both exact head
            names = ("live", "cached")
            base_ap, base_t = live(cfg_base)
            var_ap, var_t = run_one(cfg_var, store, cache=True,
                                    weights=ckpt, device=dev)
        elif mode == "fasthead":  # exact vs fast teacher head, live
            names = ("exact_head", "fast_head")
            base_ap, base_t = live(cfg_base)
            cfg_var.TPU.TEACHER_FAST_HEAD = True
            var_ap, var_t = live(cfg_var)
        elif mode in ("refresh", "refresh_int8"):
            # live per-step step_two teacher vs predictions refreshed by a
            # collection pass every 4 epochs (with int8 collection under
            # refresh_int8); both arms all step_two
            names = ("live_two", "refresh_two" if mode == "refresh"
                     else "refresh_int8_two")
            cfg_base.CLOUD.BURN_UP_STEP = 0
            cfg_var.CLOUD.BURN_UP_STEP = 0
            base_ap, base_t = live(cfg_base)
            cfg_var.TPU.TEACHER_REFRESH_EPOCHS = 4
            if mode == "refresh_int8":
                cfg_var.TPU.INT8_COLLECT = True
            var_ap, var_t = live(cfg_var)
        elif mode == "budget":
            # the teacher's proposal budget halved (foggy_fast.yaml's
            # TEACHER_POST_NMS_TOPK at fixture scale); live teacher both
            names = ("budget_full", "budget_half")
            base_ap, base_t = live(cfg_base)
            cfg_var.TPU.TEACHER_PRE_NMS_TOPK = 128
            cfg_var.TPU.TEACHER_POST_NMS_TOPK = 32
            var_ap, var_t = live(cfg_var)
        elif mode in ("shipped", "shipped_i8"):
            # the shipped foggy_fast recipe against strict parity with the
            # production phase split (burn-up at 2/3): cached step_one,
            # teacher budget halved, refresh every 4 epochs with int8
            # collection, and under shipped_i8 int8 training too
            names = ("parity", mode)
            bu = (args.iters * 2) // 3
            cfg_base.CLOUD.BURN_UP_STEP = bu
            cfg_var.CLOUD.BURN_UP_STEP = bu
            base_ap, base_t = live(cfg_base)
            cfg_var.TPU.TEACHER_PRE_NMS_TOPK = 128
            cfg_var.TPU.TEACHER_POST_NMS_TOPK = 32
            cfg_var.TPU.TEACHER_REFRESH_EPOCHS = 4
            cfg_var.TPU.INT8_COLLECT = True
            if mode == "shipped_i8":
                cfg_var.TPU.INT8_TRAIN = True
            var_ap, var_t = run_one(cfg_var, store, cache=True,
                                    weights=ckpt, device=dev)
        else:   # batch_live: the batch mode with the live teacher
            names = ("batch_base_live", "batch_double_live")
            base_ap, base_t = live(cfg_base)
            var_ap, var_t = live(_double_batch(cfg_base, cfg_var, args,
                                               root))
        return names, pre_ap, base_ap, var_ap, base_t, var_t
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


def make_fixture(args, root):
    """The fixture's train and eval sets under ``root``, registered as
    abtrain / abval, and the synthetic cloud store of the train set."""
    from coin_tpu_torch.data import voc
    classes = ("car", "person")
    gen = (voc.make_synthetic_voc_rich if args.fixture == "v3"
           else voc.make_synthetic_voc)
    gen(os.path.join(root, "synth/VOC2007"), num_images=args.images,
        split="train")
    gen(os.path.join(root, "synth/VOC2007"), num_images=args.eval_images,
        split="val", seed=7)
    voc.register_pascal_voc("abtrain", "synth/VOC2007", "train", classes,
                            ".jpg")
    voc.register_pascal_voc("abval", "synth/VOC2007", "val", classes, ".jpg")
    records = voc.load_voc_instances(os.path.join(root, "synth/VOC2007"),
                                     "train", classes, ".jpg")
    return synth_store(records, num_classes=len(classes))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fixture", choices=("v2", "v3"), default="v3",
                   help="v3: the rich 512-image fixture with the avg3 "
                        "endpoint; v2 the 64-image flat fixture")
    p.add_argument("--iters", type=int, default=None,
                   help="adaptation iters per arm (default: v2 400, v3 800)")
    p.add_argument("--eval-every", type=int, default=100)
    p.add_argument("--images", type=int, default=None,
                   help="fixture train images (default: v2 64, v3 512)")
    p.add_argument("--eval-images", type=int, default=None,
                   help="held-out eval images (default: images//2)")
    p.add_argument("--pre-iters", type=int, default=None,
                   help="CLIPDET pre-train iterations before the A/B "
                        "(default: v2 800, v3 2000)")
    p.add_argument("--seeds", type=int, default=8, help="paired seeds")
    p.add_argument("--out", default=os.path.join("output", "ab.json"))
    p.add_argument("--seed-start", type=int, default=0,
                   help="first seed index to run (earlier seeds come "
                        "from --resume-from)")
    p.add_argument("--resume-from", default="",
                   help="an earlier artifact (or its .partial) whose "
                        "per_seed rows below --seed-start are merged")
    p.add_argument("--mode", choices=MODES, default="cache")
    p.add_argument("--multi", default="",
                   help="several standard-base campaigns over shared "
                        "seeds, e.g. 'int8train_ps:0-15,aa:8-15:prior.json'"
                        " (inclusive ranges; a third field resumes seeds "
                        "below the range's start); the artifacts are "
                        "ab_<mode>_<fixture>_s<N>.json beside --out")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    v3 = args.fixture == "v3"
    if args.iters is None:
        args.iters = 800 if v3 else 400
    if args.images is None:
        args.images = 512 if v3 else 64
    if args.pre_iters is None:
        args.pre_iters = 2000 if v3 else 800
    if args.eval_images is None:
        args.eval_images = max(args.images // 2, 8)
    return args


def main(argv=None):
    from coin_tpu_torch.device import resolve_device
    args = parse_args(argv)
    args.device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO)
    root = tempfile.mkdtemp(prefix="ab_data_")
    try:
        store = make_fixture(args, root)
        if args.multi:
            run_multi(args, root, store)
            return
        per_seed, names = [], None
        if args.resume_from:
            names, per_seed = load_resume(args.resume_from, args.mode,
                                          args.fixture, args.seed_start)
        for s in range(args.seed_start, args.seeds):
            names, pre_ap, base_ap, var_ap, base_t, var_t = run_seed(
                args, root, store, s)
            row = seed_row(names, s, pre_ap, base_ap, var_ap, base_t, var_t)
            per_seed.append(row)
            flat = " EXCLUDED (pretrain flatlined)" if row["excluded"] else ""
            print(f"[seed {s}] final {names[0]}={row['final_base']} "
                  f"{names[1]}={row['final_var']}{flat}", flush=True)
            write_partial(args.out, args.mode, args, names, per_seed)
        aggregate_and_write(args.mode, args, args.out, names, per_seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def last_k_mean(ap, k=3):
    """Mean AP50 over the last ``k`` evals: the primary endpoint of
    fixture v3 (pre-registered), the secondary of v2."""
    if not ap:
        return None
    vals = [ap[k2] for k2 in sorted(ap, key=int)[-k:]]
    return float(sum(vals) / len(vals))


def seed_row(names, s, pre_ap, base_ap, var_ap, base_t, var_t):
    fb = base_ap[max(base_ap, key=int)] if base_ap else None
    fv = var_ap[max(var_ap, key=int)] if var_ap else None
    ab, av = last_k_mean(base_ap), last_k_mean(var_ap)
    return {
        "seed": s, "pretrain_ap50": pre_ap,
        "excluded": pre_ap < EXCLUDE_PRETRAIN_AP_BELOW,
        f"{names[0]}_ap50": base_ap, f"{names[1]}_ap50": var_ap,
        "final_base": fb, "final_var": fv,
        "delta": (fv - fb) if fb is not None and fv is not None
        else None,
        "avg3_base": ab, "avg3_var": av,
        "delta_avg3": (av - ab) if ab is not None and av is not None
        else None,
        f"{names[0]}_seconds": base_t, f"{names[1]}_seconds": var_t,
    }


def load_resume(path, mode, fixture, seed_start):
    with open(path) as f:
        prior = json.load(f)
    if prior["mode"] != mode:
        raise ValueError(f"{path}: mode {prior['mode']}, not {mode}")
    if prior.get("fixture", "v2") != fixture:
        raise ValueError(f"{path}: fixture {prior.get('fixture', 'v2')}, "
                         f"not {fixture}")
    per_seed = [r for r in prior["per_seed"] if r["seed"] < seed_start]
    print(f"[resume] {mode}: merged {len(per_seed)} prior seeds from "
          f"{path}")
    return tuple(prior["arms"]), per_seed


def platform(device) -> str:
    """The device of the run; on the card with its name and power limit
    as nvidia-smi gives them."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    idx = device.index or 0
    return "cuda: " + (smi[idx] if idx < len(smi)
                       else torch.cuda.get_device_name(idx))


def write_partial(out, mode, args, names, per_seed, seeds=None):
    """The artifact so far, at ``<out>.partial``: a cut-short campaign
    keeps its seeds, with the setup a resume checks against."""
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out + ".partial", "w") as f:
        json.dump({"mode": mode, "fixture": args.fixture,
                   "iters": args.iters,
                   "pretrain_iters": args.pre_iters,
                   "images": args.images,
                   "eval_images": args.eval_images,
                   "seeds": seeds or args.seeds,
                   "platform": platform(args.device),
                   "arms": list(names),
                   "completed_seeds": len(per_seed),
                   "per_seed": per_seed}, f, indent=2)


def parse_multi(spec):
    """'mode:LO-HI[:resume.json]' comma-list; HI inclusive."""
    out = []
    for part in spec.split(","):
        bits = part.split(":")
        lo, hi = (int(x) for x in bits[1].split("-"))
        out.append({"mode": bits[0], "lo": lo, "hi": hi + 1,
                    "resume": bits[2] if len(bits) > 2 else ""})
    return out


def run_multi(args, root, store):
    """Several standard-base campaigns over shared seeds in one process:
    per seed the pre-train and the cached fp base arm run once, and each
    active mode's variant arm is paired against that base. The artifacts
    say so (``base_arm_shared``)."""
    specs = parse_multi(args.multi)
    for sp in specs:
        if sp["mode"] not in STD_BASE_MODES:
            raise ValueError(f"--multi supports standard-base modes only, "
                             f"got {sp}")
        sp["rows"], sp["names"] = [], None
        sp["out"] = os.path.join(
            os.path.dirname(os.path.abspath(args.out)),
            f"ab_{sp['mode']}_{args.fixture}_s{sp['hi']}.json")
        if sp["resume"]:
            sp["names"], sp["rows"] = load_resume(
                sp["resume"], sp["mode"], args.fixture, sp["lo"])

    for s in range(min(sp["lo"] for sp in specs),
                   max(sp["hi"] for sp in specs)):
        active = [sp for sp in specs if sp["lo"] <= s < sp["hi"]]
        if not active:
            continue
        dirs = [tempfile.mkdtemp(prefix=p) for p in ("ab_pre_", "ab_base_")]
        try:
            cfg_pre = build_cfg(root, dirs[0], args.pre_iters, 10 ** 9,
                                fixture=args.fixture)
            cfg_base = build_cfg(root, dirs[1], args.iters, args.eval_every,
                                 fixture=args.fixture)
            for c in (cfg_pre, cfg_base):
                c.SEED = 2024 + 101 * s
            ckpt, pre_ap = pretrain(cfg_pre, store, args.pre_iters,
                                    args.device)
            print(f"[seed {s}] pretrain AP50 = {pre_ap:.2f} (shared by "
                  f"{[sp['mode'] for sp in active]})", flush=True)
            base_ap, base_t = run_one(cfg_base, store, cache=True,
                                      weights=ckpt, device=args.device)
            for sp in active:
                var_dir = tempfile.mkdtemp(prefix="ab_var_")
                dirs.append(var_dir)
                cfg_var = build_cfg(root, var_dir, args.iters,
                                    args.eval_every, fixture=args.fixture)
                cfg_var.SEED = 2024 + 101 * s
                names, runner = std_var(sp["mode"], cfg_base, cfg_var,
                                        args, root)
                var_ap, var_t = runner(store, ckpt)
                sp["names"] = names
                row = seed_row(names, s, pre_ap, base_ap, var_ap,
                               base_t, var_t)
                row["base_shared"] = True
                sp["rows"].append(row)
                print(f"[seed {s}] {sp['mode']}: final {names[0]}="
                      f"{row['final_base']} {names[1]}={row['final_var']}"
                      f" d_avg3={row['delta_avg3']}", flush=True)
                write_partial(sp["out"], sp["mode"], args, names,
                              sp["rows"], seeds=sp["hi"])
        finally:
            for d in dirs:
                shutil.rmtree(d, ignore_errors=True)

    shared_note = ("pretrain + cached-fp base arm run once per seed, "
                   "shared across modes "
                   + str([sp["mode"] for sp in specs])
                   + " (same-process pairing; per-campaign delta "
                     "distributions unchanged)")
    for sp in specs:
        aggregate_and_write(sp["mode"], args, sp["out"], sp["names"],
                            sp["rows"], seeds=sp["hi"],
                            extra={"base_arm_shared": shared_note})


def _mean_sd_ci(values):
    n = len(values)
    mean = float(np.mean(values)) if n else None
    sd = float(np.std(values, ddof=1)) if n > 1 else None
    half = (_T95.get(n - 1, 1.96) * sd / math.sqrt(n) if n > 1 else None)
    ci = [mean - half, mean + half] if half is not None else None
    return mean, sd, ci


def aggregate(mode, args, names, per_seed, seeds=None, extra=None):
    """The campaign's report: the mean delta with its 95 % t-interval
    over the functional seeds on both endpoints, and the verdict on the
    primary one (avg3 on fixture v3, the final eval on v2)."""
    v3 = args.fixture == "v3"
    used = [r for r in per_seed
            if not r["excluded"] and r["delta"] is not None]
    deltas = [r["delta"] for r in used]
    n = len(deltas)
    mean, sd, ci = _mean_sd_ci(deltas)
    d3 = [r["delta_avg3"] for r in used if r.get("delta_avg3") is not None]
    n3 = len(d3)
    mean3, sd3, ci3 = _mean_sd_ci(d3)
    if v3:
        p_sd, p_ci, primary = sd3, ci3, "avg3"
    else:
        p_sd, p_ci, primary = sd, ci, "final"
    report = {
        "mode": mode, "fixture": args.fixture, "iters": args.iters,
        "pretrain_iters": args.pre_iters, "images": args.images,
        "eval_images": args.eval_images,
        "seeds": seeds or args.seeds, "arms": list(names),
        "exclusion_rule": f"pretrain AP50 < {EXCLUDE_PRETRAIN_AP_BELOW}"
                          " (pre-registered)",
        "n_functional": n,
        "excluded_seeds": [r["seed"] for r in per_seed if r["excluded"]],
        "primary_endpoint": primary,
        "delta_mean": mean, "delta_sd": sd, "delta_ci95": ci,
        "delta_avg3_mean": mean3, "delta_avg3_sd": sd3,
        "delta_avg3_ci95": ci3, "n_avg3": n3,
        "n_positive_primary": sum(
            1 for d in (d3 if v3 else deltas) if d > 0),
        "n_negative_primary": sum(
            1 for d in (d3 if v3 else deltas) if d < 0),
        "n_positive_secondary": sum(
            1 for d in (deltas if v3 else d3) if d > 0),
        "n_negative_secondary": sum(
            1 for d in (deltas if v3 else d3) if d < 0),
        "avg3_note": "mean AP50 of the last 3 evals per arm — the "
                     "PRIMARY endpoint for fixture v3 (pre-registered "
                     "round 4); secondary for v2, where the verdict "
                     "stays the final-eval rule for comparability.",
        "final_base_mean": float(np.mean([r["final_base"]
                                          for r in used])) if n else None,
        "final_var_mean": float(np.mean([r["final_var"]
                                         for r in used])) if n else None,
        "verdict": (None if p_ci is None else
                    ("PASS" if p_ci[0] > -2.0 else
                     ("FAIL" if p_ci[1] < 0.0 else "INCONCLUSIVE"))),
        "verdict_rule": f"on the {primary} endpoint: PASS iff CI95 lower"
                        " bound > -2 AP50; FAIL iff CI95 upper bound"
                        " < 0",
        "platform": platform(args.device),
        "per_seed": per_seed,
    }
    if extra:
        report.update(extra)
    if mode == "aa":
        # the fixture adjudicates knobs whose effect exceeds its noise
        report["noise_floor_sd"] = p_sd
        report["noise_floor_ok"] = (p_sd is not None and p_sd <= 2.0)
        report["verdict"] = None
        report["verdict_rule"] = ("aa mode measures the noise floor; "
                                  "target: primary-endpoint delta SD "
                                  "<= 2 AP50")
    return report


def aggregate_and_write(mode, args, out, names, per_seed, seeds=None,
                        extra=None):
    report = aggregate(mode, args, names, per_seed, seeds, extra)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: v for k, v in report.items()
                      if k != "per_seed"}, indent=2))
    return report


if __name__ == "__main__":
    main()
