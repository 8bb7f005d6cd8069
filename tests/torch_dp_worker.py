"""One rank of the two-rank gloo launch of tests/test_torch_parallel.py.

    python -m tests.torch_dp_worker RANK WORLD SPEC.json

Imports nothing of JAX or coin_tpu. Each rank joins the process group
through a ``FileStore`` file (``spec["init"]``), takes its shard of a
global batch of B images and runs, in order: ``all_gather_objects``; the
union of store shards, chunked and whole; one cached adaptation step in
f32 and one with the int8 res5 (``INT8_TRAIN_SCALE tensor``), one
pre-train step and one oracle step, each data-parallel; the sharded
collection pass of the synthetic teacher and the trainer's teacher
refresh; the evaluation over batches sharded by rank. Rank 0 also runs
the single-process step on all B images from a copy of the same state
(``group=None``), the single-process collections and evaluation, and
writes the differences to ``spec["result"]`` as JSON.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import pickle
import sys
import time
from unittest import mock

import numpy as np
import torch

CLASSES = ("car", "person")
BATCH = 2
FLIPS = np.array([False, True])


def settings(cfg, root: str, out: str):
    """tests/test_torch_trainer.py's tiny settings, the batch of BATCH
    images, the f32 res5 (the int8 case turns it on), the prototype update
    from step 0."""
    cfg.DATASETS.ROOT = root
    cfg.DATASETS.TRAIN_UNLABEL = ["dpsynthtrain"]
    cfg.DATASETS.TEST = ["dpsynthval"]
    cfg.OUTPUT_DIR = out
    cfg.SOLVER.IMG_PER_BATCH_UNLABEL = BATCH
    cfg.SOLVER.MAX_ITER = 4
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.SOLVER.STEPS = [100]
    cfg.SOLVER.FACTOR_LIST = [1, 0.1]
    cfg.SOLVER.CHECKPOINT_PERIOD = 1000
    cfg.TEST.EVAL_PERIOD = 1000
    cfg.TEST.DETECTIONS_PER_IMAGE = 8
    cfg.INPUT.MIN_SIZE_TRAIN = 64
    cfg.INPUT.MIN_SIZE_TEST = 64
    cfg.INPUT.MAX_SIZE = 96
    rpn = cfg.MODEL.RPN
    rpn.PRE_NMS_TOPK_TRAIN = rpn.PRE_NMS_TOPK_TEST = 64
    rpn.POST_NMS_TOPK_TRAIN = rpn.POST_NMS_TOPK_TEST = 16
    rpn.BATCH_SIZE_PER_IMAGE = 16
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.MODEL.MERGE_DIM = 1024
    tpu = cfg.TPU
    tpu.TEXT_LAYERS, tpu.TEXT_WIDTH, tpu.TEXT_HEADS = 1, 32, 2
    tpu.COMPUTE_DTYPE = "float32"
    tpu.CAP_TEACHER = 8
    tpu.TEACHER_PRE_NMS_TOPK = 32
    tpu.TEACHER_POST_NMS_TOPK = 4
    tpu.CAP_C = 8
    tpu.INT8_TRAIN = False
    tpu.INT8_TRAIN_SCALE = "tensor"
    tpu.INT8_COLLECT = True
    tpu.CACHE_TEACHER_MIN_STEPS = 0
    cfg.CLOUD.BURN_UP_STEP = 2
    cfg.CLOUD.PROTOTYPE_UPDATE_START = 0
    cfg.CLOUD.CLASSES_WEIGHT = [1.0, 1.0, 0.9]
    return cfg


def register(root: str) -> None:
    from coin_tpu_torch.data import voc
    voc.register_pascal_voc("dpsynthtrain", "synth/VOC2007", "train",
                            CLASSES, ".jpg")
    voc.register_pascal_voc("dpsynthval", "synth/VOC2007", "val", CLASSES,
                            ".jpg")


def make_data(root: str) -> str:
    """The synthetic sets and the cloud store npz (its path)."""
    from coin_tpu_torch.data import voc
    from coin_tpu_torch.tools.validate import synth_store
    voc.make_synthetic_voc(os.path.join(root, "synth/VOC2007"),
                           num_images=8, split="train")
    voc.make_synthetic_voc(os.path.join(root, "synth/VOC2007"),
                           num_images=4, split="val", seed=7)
    records = voc.load_voc_instances(os.path.join(root, "synth/VOC2007"),
                                     "train", CLASSES, ".jpg")
    npz = os.path.join(root, "collect.npz")
    synth_store(records, len(CLASSES)).save(npz)
    return npz


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b|."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def upd_rel(a: torch.Tensor, b: torch.Tensor, base: torch.Tensor) -> float:
    """The update a - base against b - base: max |a - b| less the f32
    rounding of the parameters it was taken from (2 ulp of the largest
    |base|, tests/test_torch_train_step.py's ``_close``), over the largest
    |b - base|."""
    ulps = 2 * float(np.spacing(np.float32(base.abs().max())))
    err = float((a.detach().double() - b.detach().double()).abs().max()) \
        - ulps
    return max(err, 0.0) / max(float((b - base).abs().max()), 1e-30)


def clone_state(state):
    """A deep copy of a TrainState, its generator at the same state."""
    gen = state.generator
    state.generator = None
    try:
        out = copy.deepcopy(state)
    finally:
        state.generator = gen
    out.generator = torch.Generator(device=gen.device)
    out.generator.set_state(gen.get_state())
    return out


def offline_from(online, first: int = 0):
    """The cached teacher's detections: the online ones with the class of
    every box of an odd sum of global image index (``first`` is the local
    image 0's) and box index moved to the next class (inconsistent: B
    rows), the rest kept (consistent: A rows)."""
    c = len(CLASSES)
    b, n = online.classes.shape
    moved = ((torch.arange(b)[:, None] + first + torch.arange(n)[None]) % 2
             == 1) & online.valid
    classes = torch.where(moved, (online.classes + 1) % c, online.classes)
    probs = online.probs.clone()
    probs[..., :c] = torch.where(moved[..., None],
                                 probs[..., :c].roll(1, -1), probs[..., :c])
    return online.replace(classes=classes.int(), probs=probs,
                          scores=probs[..., :c].amax(-1))


def compare(dp, ref, before, losses_dp, losses_ref, merge=False):
    """The differences of a data-parallel step from the single-process
    one: each updated tensor's update (and each prototype) over its
    largest entry, the losses over theirs."""
    out = {"losses": rel(torch.stack([losses_dp[k] for k in losses_ref]),
                         torch.stack(list(losses_ref.values())))}
    upd = []
    a = dict(dp.model.named_parameters())
    for n, p in ref.model.named_parameters():
        if p.requires_grad:
            upd.append(upd_rel(a[n], p, before["model"][n]))
    out["update"] = max(upd)
    names = [n for n, p in ref.model.named_parameters() if p.requires_grad]
    out["worst"] = sorted(zip(upd, names))[-3:]
    out["moved"] = any(bool((p != before["model"][n]).any()) for n, p in
                       ref.model.named_parameters() if p.requires_grad)
    if merge:
        a = dict(dp.merge_model.named_parameters())
        out["merge_update"] = max(
            upd_rel(a[n], p, before["merge"][n])
            for n, p in ref.merge_model.named_parameters())
        out["merge_moved"] = any(
            bool((p != before["merge"][n]).any())
            for n, p in ref.merge_model.named_parameters())
    if ref.prototypes is not None:
        out["prototypes"] = max(
            rel(getattr(dp.prototypes, f), getattr(ref.prototypes, f))
            for f in ("proto", "b_online", "b_offline"))
        out["proto_moved"] = not torch.equal(ref.prototypes.proto,
                                             before["proto"])
    return out


def snapshot(state):
    snap = {"model": {n: p.detach().clone()
                      for n, p in state.model.named_parameters()}}
    if state.merge_model is not None:
        snap["merge"] = {n: p.detach().clone()
                         for n, p in state.merge_model.named_parameters()}
    if state.prototypes is not None:
        snap["proto"] = state.prototypes.proto.clone()
    return snap


def batch_inputs(loader, indices, flips):
    """Images, sizes, both cloud views and the ground truth of the images
    ``indices``, as the trainers' loops put them on the CPU."""
    from coin_tpu_torch.engine.oracle import gt_detections
    from coin_tpu_torch.engine.pre_train import online_view_to_detections
    batch = loader._attach_store(loader.pack_batch(indices, flips))
    view = lambda v: online_view_to_detections(v, "cpu")
    return dict(images=torch.from_numpy(batch.images),
                hw=torch.from_numpy(batch.image_hw),
                rcnn=view(batch.online["RCNN"]), rpn=view(batch.online["RPN"]),
                gt=gt_detections(batch, "cpu"))


def run(rank: int, world: int, spec: dict) -> dict:
    from coin_tpu_torch.config import load_config
    from coin_tpu_torch.engine import pipelines
    from coin_tpu_torch.engine.cloud_factory import build_synthetic_detector
    from coin_tpu_torch.engine.collect import collect_cloud
    from coin_tpu_torch.engine.evaluator import evaluate_detector
    from coin_tpu_torch.engine.oracle import build_oracle_step, \
        init_oracle_state
    from coin_tpu_torch.engine.pre_train import build_pretrain_step, \
        init_pretrain_state
    from coin_tpu_torch.data.loader import TestLoader
    from coin_tpu_torch.engine.results_store import ResultStore
    from coin_tpu_torch.engine.step_builder import build_adaptation_steps
    from coin_tpu_torch.engine.trainer import CoinTrainer
    from coin_tpu_torch.ops import qconv
    from coin_tpu_torch.parallel import mesh_utils, multihost
    res = {"seconds": {}}
    tick = time.perf_counter()

    def lap(name):
        nonlocal tick
        now = time.perf_counter()
        res["seconds"][name] = round(now - tick, 2)
        tick = now

    # ---- host-side gathers and the store union
    got = multihost.all_gather_objects({"rank": rank, "pad": "x" * rank})
    res["gather"] = [g["rank"] for g in got] == list(range(world)) and all(
        g["pad"] == "x" * g["rank"] for g in got)
    full = ResultStore.load(spec["npz"])
    ids = sorted(full.image_ids())
    union = {}
    for label, chunk in (("chunked", 64), ("whole", 512 << 20)):
        shard = ResultStore(full.num_classes)
        shard._data = {i: full._data[i] for i in ids[rank::world]}
        got = multihost.merge_result_stores(shard, chunk_bytes=chunk)
        union[label] = sorted(got.image_ids()) == ids and all(
            all(np.array_equal(got._data[i][k], full._data[i][k])
                for k in full._data[i]) for i in ids)
    res["union"] = union
    if rank == 0:
        got.save(spec["union_npz"])
    lap("gather_union")

    # ---- the trainer (f32), its state copied before each step
    cfg = settings(load_config(), spec["root"], spec["out"])
    store = ResultStore.load(spec["npz"])
    tr = CoinTrainer(cfg, store=store, device="cpu")
    res["loader_batch"] = tr.train_loader.batch_size
    group = tr.group
    lap("trainer")
    b = BATCH // world
    mine = list(range(rank * b, (rank + 1) * b))
    x = batch_inputs(tr.train_loader, mine, FLIPS[mine])
    xs = batch_inputs(tr.train_loader, list(range(BATCH)), FLIPS)

    # the four steps' states: the f32 trainer's, the int8 res5's (qt 1,
    # one scale per tensor), the pre-train's and the oracle's, every model
    # holding the trainer's weights
    from coin_tpu_torch.engine.step_builder import init_train_state
    icfg = cfg.clone()
    icfg.TPU.INT8_TRAIN = True

    def model_like(c):
        m = pipelines.build_detector(c, tr.num_classes, "cpu")
        m.load_state_dict(tr.state.model.state_dict())
        return m
    proto0 = tr.init_prototypes()
    adapt = lambda g: build_adaptation_steps(
        tr.tokens, tr.pcfg, tr.teacher_pcfg, hyper_of(tr), group=g)[1]
    cases = {
        "adapt_f32": (tr.state, adapt, lambda st, s, v, first: st(
            s, v["images"], v["hw"], v["rcnn"], v["rpn"],
            offline_from(v["rcnn"], first))),
        "adapt_int8": (init_train_state(icfg, model_like(icfg), tr.tokens,
                                        cfg.SEED, proto0=proto0), adapt,
                       None),
        "pretrain": (init_pretrain_state(cfg, model_like(cfg), cfg.SEED,
                                         proto0),
                     lambda g: build_pretrain_step(
                         tr.tokens, tr.pcfg,
                         cfg.CLOUD.PROTOTYPE_UPDATE_WEIGHT, False,
                         tr.loss_weights, group=g),
                     lambda st, s, v, first: st(s, v["images"], v["hw"],
                                                v["rcnn"], v["rpn"], True)),
        "oracle": (init_oracle_state(cfg, model_like(cfg), cfg.SEED),
                   lambda g: build_oracle_step(tr.tokens, tr.pcfg, group=g),
                   lambda st, s, v, first: st(s, v["images"], v["hw"],
                                              v["gt"])),
    }
    cases["adapt_int8"] = cases["adapt_int8"][:2] + cases["adapt_f32"][2:]
    # each rank runs the single-process references of its half of the
    # cases at once, then both ranks run the data-parallel steps
    owner = {"adapt_f32": 0, "pretrain": 0, "adapt_int8": 1, "oracle": 1}
    refs, befores, scales = {}, {}, {}
    for name, (state, build, call) in cases.items():
        befores[name] = snapshot(state)
        if owner[name] == rank % 2:
            with mock.patch.object(qconv, "quantize_plain", recorder(
                    qconv.quantize_plain, scales, name + "/single")):
                refs[name] = call(build(None), clone_state(state), xs, 0)
                if name == "adapt_int8":
                    with backbone_by_rank(type(state.model), world):
                        refs["split"] = call(build(None), clone_state(state),
                                             xs, 0)
    lap("references")
    for name, (state, build, call) in cases.items():
        with mock.patch.object(qconv, "quantize_given_plain", recorder(
                qconv.quantize_given_plain, scales, name + "/given")):
            dp, ldp = call(build(group), state, x, mine[0])
        if name in refs:
            ref, lref = refs[name]
            out = compare(dp, ref, befores[name], ldp, lref,
                          merge=name.startswith("adapt"))
            if name == "adapt_int8":
                split, lsplit = refs["split"]
                out["vs_split"] = compare(dp, split, befores[name], ldp,
                                          lsplit, merge=True)
                out["witness"] = compare(ref, split, befores[name], lref,
                                         lsplit, merge=True)
                out["scale"] = rel(scales[name + "/given"],
                                   scales[name + "/single"])
                out["given_launched"] = name + "/given" in scales
            res[name] = out
        lap(name)
    for part in multihost.all_gather_objects(
            {k: res[k] for k in owner if k in res}):
        res.update(part)

    # ---- sharded collection (synthetic teacher) and the teacher refresh
    det = build_synthetic_detector(CLASSES, "cpu")
    kw = dict(min_size=64, max_size=96, batch_size=1)
    got = collect_cloud(det, TestLoader("dpsynthtrain", spec["root"],
                                        rank=rank, world=world, **kw),
                        len(CLASSES), device="cpu")
    fresh = tr.collect_teacher_store()
    if rank == 0:
        with mock.patch.object(multihost, "process_count", lambda: 1):
            want = collect_cloud(det, TestLoader("dpsynthtrain",
                                                 spec["root"], **kw),
                                 len(CLASSES), device="cpu")
            loader = tr._collect_loader
            tr._collect_loader = TestLoader(
                "dpsynthtrain", spec["root"], batch_size=loader.batch_size,
                min_size=loader.min_size, max_size=loader.max_size,
                canvas_hw=loader.canvas_hw)
            want_fresh = tr.collect_teacher_store()
        res["collect"] = same_store(got, want)
        res["refresh"] = same_store(fresh, want_fresh)
        res["images"] = len(want)
    lap("collect")

    # ---- sharded evaluation: 3 batches of 3 of the 8 train images (the
    # last one padded), batch j on rank j mod 2 (so the gather returns
    # batches 0, 2, 1), against one process
    # (every score kept: the tiny random detector scores below 0.05)
    ev = dict(min_size=64, max_size=96, batch_size=3)
    model = tr.state.model
    pcfg = dataclasses.replace(tr.pcfg, test_score_thresh=0.0)
    evaluate = lambda loader, pkl: evaluate_detector(
        model, model.state_dict(), loader, tr.class_tokens, pcfg,
        save_pkl=pkl if rank == 0 else None)
    sharded = os.path.join(spec["root"], "sharded.pckl")
    got = evaluate(TestLoader("dpsynthtrain", spec["root"], rank=rank,
                              world=world, **ev), sharded)
    if rank == 0:
        single = os.path.join(spec["root"], "single.pckl")
        want = evaluate(TestLoader("dpsynthtrain", spec["root"], **ev),
                        single)
        with open(sharded, "rb") as f, open(single, "rb") as g:
            rows, want_rows = f.read(), g.read()
        with open(single, "rb") as g:
            n_dets = sum(len(v) for per in pickle.load(g).values()
                         for v in per.values())
        # NaN APs (a class without ground truth) compare as text
        res["eval"] = dict(ap=json.dumps(got) == json.dumps(want),
                           pickle=rows == want_rows, detections=n_dets)
    lap("eval")
    res["world"] = mesh_utils.world_size(group)
    return res


def backbone_by_rank(cls, world: int):
    """Patch ``cls.features`` to run the backbone on the batch's W shards
    one after another, B / W images a call, as the W ranks run it, and to
    concatenate the features: the single-process step with the ranks'
    backbone (oneDNN's convolutions round otherwise over 1 image than
    over 2)."""
    features = cls.features

    def by_rank(self, images):
        return torch.cat([features(self, part)
                          for part in images.chunk(world)])
    return mock.patch.object(cls, "features", by_rank)


def hyper_of(tr):
    from coin_tpu_torch.engine.step_builder import hyper_from_cfg
    return dataclasses.replace(hyper_from_cfg(tr.cfg),
                               loss_weights=tr.loss_weights)


def recorder(fn, into: dict, key: str):
    """``fn``, recording the scale of its first call under ``key``."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        into.setdefault(key, out[1].detach().clone())
        return out
    return wrapped


def same_store(a, b) -> bool:
    ids = sorted(b.image_ids())
    return sorted(a.image_ids()) == ids and all(
        sorted(a._data[i]) == sorted(b._data[i]) and all(
            np.array_equal(a._data[i][k], b._data[i][k])
            for k in b._data[i]) for i in ids)


def main(argv) -> int:
    rank, world, spec_path = int(argv[0]), int(argv[1]), argv[2]
    torch.set_num_threads(2)
    with open(spec_path) as f:
        spec = json.load(f)
    register(spec["root"])
    from coin_tpu_torch.parallel import mesh_utils
    store = torch.distributed.FileStore(spec["init"], world)
    torch.distributed.init_process_group("gloo", store=store, rank=rank,
                                         world_size=world)
    try:
        res = run(rank, world, spec)
        res["world_size"] = mesh_utils.world_size(
            torch.distributed.group.WORLD)
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        with open(spec["result"], "w") as f:
            json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
