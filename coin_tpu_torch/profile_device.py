"""Kernel-level profile of the port on one CUDA card.

    python -m coin_tpu_torch.profile_device
        [--path eval|train|collect|collect_glip|clip] [--iters 5]
        [--int8-roi]

``--path eval``: the full-width bf16 detector of
configs/coin/GDINO/foggy_fast.yaml with random weights from a seed,
``--iters`` calls of ``normalize_batch`` + ``engine.pipelines.inference``
on one batch of 4 random u8 images already on the card (host decode
excluded; the text features are computed once beforehand, as
``evaluate_detector`` does).

``--path train``: ``--iters`` calls of ``train_step_cached`` of
configs/coin/GDINO/foggy_fast.yaml at full width (bf16 with the int8 res5
of ``TPU.INT8_TRAIN``, batch 3 on the 608 x 1216 canvas, 128 synthetic
cloud boxes per image, the teacher's own predictions at its 512-proposal
budget as the cached ones), with the optimizers past warmup. With
``--int8-roi``, the int8train_ps_roi configuration instead: per-sample
int8 res5 without the int8 wgrad (TPU.INT8_TRAIN_SCALE sample,
INT8_TRAIN_WGRAD false) and the int8 RoIAlign (TPU.INT8_ROI: K5, K5b).

``--path collect``: ``--iters`` collection batches of the GDINO cloud
teacher of foggy_fast.yaml at full width (Swin-B, 900 queries, 6 + 6
layers, BERT-base; bf16 over f32 parameters; random weights in the
official checkpoint layout): the detector on 4 random u8 images on the
608 x 1216 canvas, then the fusion NMS of CLOUD.NMS_METHOD.

``--path collect_glip``: the same over collection batches of the GLIP
cloud teacher of configs/coin/GLIP/foggy.yaml at full width (Swin-L, 8
VLDyHead blocks, BERT-base; bf16 over f32 parameters, DyConv in f32;
random weights in the official checkpoint layout).

``--path clip``: the CLIP re-scoring batch of foggy_fast.yaml's
collection stage (``build_clip_scorer`` from a random full-width RN50
checkpoint in OpenAI's layout: the bf16 visual tower, the attention pool
in f32), both views of 128 boxes on 4 random u8 images.

Prints the device time per call by kernel group and the top kernels, and
the device's busy share of the window: the kernels' summed time over the
host's wall time (the port launches on one stream, so kernels do not
overlap). Raises without a card, and when the profiler records no device
time.
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
from coin_tpu_torch.engine.common import (simple_class_tokens,
                                          synthetic_detections)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs/coin")
SEED = 2024

# kernel name fragment → group, first match wins
GROUPS = (
    ("port kernels", ("roi_align_fwd_kernel", "roi_align_bwd_kernel",
                      "nms_mask_kernel", "nms_sweep_kernel",
                      "normalize_kernel", "gray_mean_kernel",
                      "vertical_kernel", "horizontal_kernel",
                      "qconv_kernel", "wgrad_kernel", "finish_kernel",
                      "quant_tensor_kernel", "quant_sample_kernel",
                      "quant_weight",
                      "window_attention_kernel", "ms_deform_kernel",
                      "fusion_nms_kernel", "deform_conv_kernel",
                      "deform_conv_reduce", "roi_align_int8_kernel",
                      "roi_align_int8_bwd_kernel", "self_cluster_kernel",
                      "resize_weights", "resize_rows", "resize_cols",
                      "normalize_flip_kernel")),
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


def eval_call(device):
    """One eval batch of foggy_fast.yaml, as a closure."""
    cfg = load_config(os.path.join(CONFIGS, "GDINO/foggy_fast.yaml"))
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

    @torch.inference_mode()
    def call():
        return pipelines.inference(model, normalize_batch(images_u8),
                                   image_hw, tokens, pcfg,
                                   text_features=text)
    return call


# the int8train_ps arm of tools/validate_cached_teacher.py:243-248 (with
# TPU.INT8_ROI on top, the int8train_ps_roi arm)
INT8_PS = {"INT8_TRAIN_WGRAD": False, "INT8_TRAIN_SCALE": "sample"}
INT8_PS_ROI = dict(INT8_PS, INT8_ROI=True)


def train_calls(device, config="GDINO/foggy_fast.yaml", tpu=None):
    """The step flavours of ``config`` at full width (with the TPU.*
    overrides ``tpu``, e.g. :data:`INT8_PS_ROI`), as closures over one
    state and one batch: ``live`` (``train_step``), ``cached``
    (``train_step_cached``), ``cached_two`` (``train_step_cached_two``)
    and ``collect``, the collection pass's call on the same batch (the
    teacher's inference at its proposal budget, through its int8 clone
    under TPU.INT8_COLLECT). Batch IMG_PER_BATCH_UNLABEL on the
    TPU.IMAGE_HW canvas, 128 synthetic cloud boxes per image, the
    teacher's own predictions as the cached ones, the optimizers past
    warmup."""
    import dataclasses
    from coin_tpu_torch.engine import step_builder as sb
    cfg = load_config(os.path.join(CONFIGS, config))
    for key, value in (tpu or {}).items():
        cfg.TPU[key] = value
    num_classes = len(CITYSCAPES_CLASSES)
    pcfg = pipelines.pipeline_config_from(cfg, num_classes)
    g = cfg.get_path
    teacher_pcfg = dataclasses.replace(
        pcfg, pre_nms_topk_test=g("TPU.TEACHER_PRE_NMS_TOPK",
                                  pcfg.pre_nms_topk_test),
        post_nms_topk_test=g("TPU.TEACHER_POST_NMS_TOPK",
                             pcfg.post_nms_topk_test))
    model = pipelines.build_detector(cfg, num_classes, device)
    model.random_init(SEED)
    tokens = torch.as_tensor(simple_class_tokens(num_classes + 1),
                             device=device).long()
    state = sb.init_train_state(cfg, model, tokens, SEED)
    state.optimizer.count = state.merge_optimizer.count = \
        cfg.SOLVER.WARMUP_ITERS
    hyper = dataclasses.replace(sb.hyper_from_cfg(cfg), proto_start=0,
                                loss_weights=pipelines.loss_weights_from(cfg))
    live, cached, cached_two = sb.build_adaptation_steps(
        tokens, pcfg, teacher_pcfg, hyper)
    gen = torch.Generator().manual_seed(SEED)
    b, (h, w) = cfg.SOLVER.IMG_PER_BATCH_UNLABEL, cfg.TPU.IMAGE_HW
    images_u8 = torch.randint(0, 256, (b, h, w, 3), generator=gen,
                              dtype=torch.uint8).to(device)
    image_hw = torch.tensor([[h, w]] * b, dtype=torch.float32, device=device)
    cap = cfg.TPU.CAP_TEACHER
    online = [synthetic_detections(gen, b, cap, num_classes, (h, w),
                                   [48] * b).map(lambda t: t.to(device))
              for _ in range(2)]
    with torch.inference_mode():
        offline = pipelines.inference(state.teacher,
                                      normalize_batch(images_u8), image_hw,
                                      tokens, teacher_pcfg)
    teacher = (state.teacher.clone(quant_convs=True)
               if g("TPU.INT8_COLLECT", False) else state.teacher)

    @torch.inference_mode()
    def collect():
        return pipelines.inference(teacher, normalize_batch(images_u8),
                                   image_hw, tokens, teacher_pcfg)
    return {"live": lambda: live(state, images_u8, image_hw, *online),
            "cached": lambda: cached(state, images_u8, image_hw, *online,
                                     offline),
            "cached_two": lambda: cached_two(state, images_u8, image_hw,
                                             *online, offline),
            "collect": collect, "batch": b}


def _vocab_tokenizer():
    """A WordPiece tokenizer over the Foggy Cityscapes class words."""
    import tempfile
    from coin_tpu_torch.models.wordpiece import WordPieceTokenizer
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "."] + sorted(
        {w for n in CITYSCAPES_CLASSES for w in n.split()})
    with tempfile.NamedTemporaryFile("w", suffix=".txt") as vocab:
        vocab.write("\n".join(words) + "\n")
        vocab.flush()
        return WordPieceTokenizer(vocab.name)


def _collect_batch(det, cfg, device):
    """``det`` and the collection NMS of ``cfg`` on 4 random u8 images on
    the card, as a closure."""
    from coin_tpu_torch.engine import collect as collect_mod
    fusion = collect_mod.parse_nms_method(cfg.CLOUD.NMS_METHOD)
    thresh = cfg.CLOUD.TEACHER_CLOUD.COLLECT_NMS_THRESH
    gen = torch.Generator().manual_seed(SEED)
    h, w = cfg.TPU.IMAGE_HW
    images_u8 = torch.randint(0, 256, (4, h, w, 3), generator=gen,
                              dtype=torch.uint8).to(device)
    image_hw = torch.tensor([[h, w]] * 4, dtype=torch.float32, device=device)

    @torch.inference_mode()
    def call():
        return collect_mod.postprocess(det(images_u8, image_hw), fusion,
                                       thresh)
    return call


def collect_glip_call(device):
    """One collection batch of configs/coin/GLIP/foggy.yaml's GLIP-L
    teacher, as a closure."""
    from coin_tpu_torch.models.convert_gdino import bert_model
    from coin_tpu_torch.models.convert_glip import BERT_PREFIX, convert_glip
    from coin_tpu_torch.models.glip import GLIP
    from coin_tpu_torch.models.glip_detector import GLIPDetector
    from coin_tpu_torch.models.manifests import glip_manifest
    cfg = load_config(os.path.join(CONFIGS, "GLIP/foggy.yaml"))
    variant = cfg.MODEL.TEACHER_CLOUD.TYPE
    gen = torch.Generator().manual_seed(SEED)
    sd = {}
    for k, shape in glip_manifest(variant)[0].items():
        sd[k] = torch.randn(shape, generator=gen) * 0.02
        if len(shape) == 1 and not k.endswith(".bias") and (
                "norm" in k or "LayerNorm" in k or ".bn." in k):
            sd[k] += 1.0          # norms near 1, as a trained model has
    model = GLIP(variant, 8, dtype=torch.bfloat16)
    model.load_state_dict(convert_glip(sd, variant))
    bert = bert_model(sd, BERT_PREFIX)
    del sd
    det = GLIPDetector(model, bert, CITYSCAPES_CLASSES, _vocab_tokenizer(),
                       threshold=cfg.MODEL.TEACHER_CLOUD.TEST_THRESHOLD,
                       device=device)
    return _collect_batch(det, cfg, device)


def collect_call(device):
    """One collection batch of foggy_fast.yaml's GDINO teacher, as a
    closure."""
    from coin_tpu_torch.models.convert_gdino import bert_model, convert_gdino
    from coin_tpu_torch.models.gdino import GroundingDINO
    from coin_tpu_torch.models.gdino_detector import GDINODetector
    from coin_tpu_torch.models.manifests import (gdino_manifest,
                                                 synth_state_dict)
    cfg = load_config(os.path.join(CONFIGS, "GDINO/foggy_fast.yaml"))
    sd = synth_state_dict(gdino_manifest(cfg.MODEL.TEACHER_CLOUD.TYPE)[0],
                          seed=SEED)
    model = GroundingDINO(cfg.MODEL.TEACHER_CLOUD.TYPE, 900, 6, 6,
                          dtype=torch.bfloat16)
    model.load_state_dict(convert_gdino(sd, cfg.MODEL.TEACHER_CLOUD.TYPE))
    bert = bert_model(sd)
    del sd
    det = GDINODetector(model, bert, CITYSCAPES_CLASSES, _vocab_tokenizer(),
                        threshold=cfg.MODEL.TEACHER_CLOUD.TEST_THRESHOLD,
                        device=device)
    return _collect_batch(det, cfg, device)


def clip_call(device):
    """One CLIP re-scoring batch of foggy_fast.yaml (the scorer of
    ``build_clip_scorer`` from a random full-width RN50 checkpoint: bf16
    visual tower, attention pool in f32) on 4 random u8 images on the
    608 x 1216 canvas, both views (RCNN and RPN) of TPU.CAP_TEACHER random
    boxes each, as a closure."""
    import tempfile
    from coin_tpu_torch.engine.cloud_factory import build_clip_scorer
    from coin_tpu_torch.models.manifests import clip_assets
    cfg = load_config(os.path.join(CONFIGS, "GDINO/foggy_fast.yaml"))
    with tempfile.TemporaryDirectory() as d:
        cfg.TPU.CLIP_WEIGHTS, cfg.TPU.CLIP_BPE_VOCAB = clip_assets(
            d, CITYSCAPES_CLASSES, cfg.DATASETS.STYLE_NAME or "realistic",
            seed=SEED)
        scorer = build_clip_scorer(cfg, CITYSCAPES_CLASSES, device)
    gen = torch.Generator().manual_seed(SEED)
    h, w = cfg.TPU.IMAGE_HW
    images_u8 = torch.randint(0, 256, (4, h, w, 3), generator=gen,
                              dtype=torch.uint8).to(device)
    views = [synthetic_detections(gen, 4, cfg.TPU.CAP_TEACHER,
                                  len(CITYSCAPES_CLASSES), (h, w),
                                  [cfg.TPU.CAP_TEACHER] * 4).boxes.to(device)
             for _ in range(2)]

    @torch.inference_mode()
    def call():
        return [scorer(images_u8, boxes) for boxes in views]
    return call


def profile_calls(path: str, iters: int, device="cuda",
                  int8_roi: bool = False):
    """(wall ms per call, {kernel name: (ms per call, launches per
    call)}) over ``iters`` profiled calls of ``path``."""
    device = resolve_device(device)
    if path == "train":
        call = train_calls(device, tpu=INT8_PS_ROI if int8_roi
                           else None)["cached"]
    else:
        call = {"eval": eval_call, "collect": collect_call,
                "collect_glip": collect_glip_call,
                "clip": clip_call}[path](device)
    for _ in range(2):
        call()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
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
    parser.add_argument("--path", choices=("eval", "train", "collect",
                                           "collect_glip", "clip"),
                        default="eval")
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--int8-roi", action="store_true",
                        help="--path train: the int8train_ps_roi arm")
    args = parser.parse_args()
    wall_ms, kernels = profile_calls(args.path, args.iters,
                                     int8_roi=args.int8_roi)
    busy = sum(ms for ms, _ in kernels.values())
    what = {"eval": "one eval batch (4 images, bf16)",
            "train": "one train_step_cached (3 images, bf16, "
                     + ("per-sample int8 res5, int8 RoIAlign)"
                        if args.int8_roi else "int8 res5)"),
            "collect": "one GDINO collection batch (4 images, bf16, fusion "
                       "NMS)",
            "collect_glip": "one GLIP-L collection batch (4 images, bf16 "
                            "with DyConv in f32, fusion NMS)",
            "clip": "one CLIP re-scoring batch (4 images, both views, "
                    "bf16 RN50)"}[args.path]
    print(f"{torch.cuda.get_device_name(0)}: {what} {wall_ms:.3f} ms wall, "
          f"{busy:.3f} ms of kernels: device busy "
          f"{100 * busy / wall_ms:.1f} %, idle {100 - 100 * busy / wall_ms:.1f}"
          f" % (over {args.iters} calls)")
    groups = defaultdict(float)
    for name, (ms, _) in kernels.items():
        groups[group_of(name)] += ms
    print("device ms per call by kernel group:")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {group:16s} {ms:9.3f} ms  {100 * ms / busy:5.1f} %")
    print("top kernels, ms and launches per call:")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        print(f"  {ms:9.3f} ms  {n:5.1f}x  [{group_of(name)}] {name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
