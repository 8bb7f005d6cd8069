"""Copy of coin_tpu/config.py (host-only), kept so the port imports nothing of
coin_tpu. Config system: a light yacs-compatible CfgNode with YAML `_BASE_`
inheritance and dotted CLI overrides (mirrors the reference's config stack,
coin/config.py + detectron2 CfgNode, without the yacs dependency).
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List, Optional

import yaml


class CfgNode(dict):
    """dict with attribute access and recursive merge."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "CfgNode":
        node = CfgNode()
        for k, v in d.items():
            node[k] = CfgNode.from_dict(v) if isinstance(v, dict) else v
        return node

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def merge_from_other(self, other: Dict[str, Any]) -> None:
        for k, v in other.items():
            if (k in self and isinstance(self[k], CfgNode)
                    and isinstance(v, dict)):
                self[k].merge_from_other(v)
            else:
                self[k] = (CfgNode.from_dict(v) if isinstance(v, dict)
                           else copy.deepcopy(v))

    def merge_from_file(self, path: str) -> None:
        self.merge_from_other(_load_yaml_with_base(path))

    def merge_from_list(self, opts: List[str]) -> None:
        """KEY VALUE pairs, dotted keys; values parsed as python literals."""
        assert len(opts) % 2 == 0, f"odd override list: {opts}"
        for key, val in zip(opts[::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    node[p] = CfgNode()
                node = node[p]
            try:
                node[parts[-1]] = ast.literal_eval(val)
            except (ValueError, SyntaxError):
                # yacs-style quoting failed — accept yaml scalars/lists
                # too ("[foggyval_0.02]" works without inner quotes)
                try:
                    node[parts[-1]] = yaml.safe_load(val)
                except yaml.YAMLError:
                    node[parts[-1]] = val

    def get_path(self, dotted: str, default=None):
        node = self
        for p in dotted.split("."):
            if not isinstance(node, dict) or p not in node:
                return default
            node = node[p]
        return node


def _load_yaml_with_base(path: str) -> Dict[str, Any]:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    base = data.pop("_BASE_", None)
    if base:
        base_path = base if os.path.isabs(base) else os.path.join(
            os.path.dirname(path), base)
        merged = CfgNode.from_dict(_load_yaml_with_base(base_path))
        merged.merge_from_other(data)
        return merged
    return data


def default_config() -> CfgNode:
    """The full default schema (superset of coin/config.py:17-143, adapted
    to the TPU runtime: static shape capacities, mesh settings)."""
    return CfgNode.from_dict({
        "OUTPUT_DIR": "./output/run",
        "SEED": 2024,
        "RESUME": False,
        "MODEL": {
            "META_ARCHITECTURE": "OpenVocabularyRCNN",
            "WEIGHTS": "",
            "RESNETS": {"DEPTH": 50},
            # detectron2 default: freeze stem + layer1 (utils.py:243-283;
            # the reference never overrides it, so stem/res2 are frozen
            # in every reference run even with CLOUD.UPDATE_BACKBONE)
            "BACKBONE": {"FREEZE_AT": 2},
            "MERGE": "CKGNet",
            "MERGE_DIM": 1024,
            "ANCHOR_GENERATOR": {
                "SIZES": [32, 64, 128, 256, 512],
                "ASPECT_RATIOS": [0.5, 1.0, 2.0],
            },
            "RPN": {
                "IOU_THRESHOLDS": [0.3, 0.7],
                "BATCH_SIZE_PER_IMAGE": 256,
                "POSITIVE_FRACTION": 0.5,
                "NMS_THRESH": 0.7,
                "PRE_NMS_TOPK_TRAIN": 6000,
                "POST_NMS_TOPK_TRAIN": 1000,
                "PRE_NMS_TOPK_TEST": 6000,
                "POST_NMS_TOPK_TEST": 1000,
                "LOSS_WEIGHT": 1.0,
                "BBOX_REG_LOSS_WEIGHT": 1.0,
            },
            "ROI_HEADS": {
                "BATCH_SIZE_PER_IMAGE": 512,
                "POSITIVE_FRACTION": 0.25,
                "IOU_THRESHOLDS": [0.5],
                "SCORE_THRESH_TEST": 0.05,
                "NMS_THRESH_TEST": 0.5,
                "POOLING_TYPE": "meanpool",
                "PROPOSAL_APPEND_GT": True,
            },
            "ROI_BOX_HEAD": {
                "POOLER_RESOLUTION": 14,
                "POOLER_SAMPLING_RATIO": 2,
                "CLS_AGNOSTIC_BBOX_REG": True,
                "BBOX_REG_WEIGHTS": [10.0, 10.0, 5.0, 5.0],
            },
            "TEACHER_CLOUD": {
                "META_ARCHITECTURE": "GDINO",
                "TYPE": "swinB",
                "WEIGHT": "",
                "TEST_THRESHOLD": 0.25,
                "PER_CLASS_TEST": False,
                # per-(query,class)-pair filtering (gdino.py:193-203)
                "USE_DINO_TYPE_FILTER": False,
            },
            "TEACHER_OFFLINE": {
                "META_ARCHITECTURE": "CLIP",
                "TYPE": "RN50",
                "TEXT_ENCODER": "CLIP_TEXT",
            },
        },
        "INPUT": {
            "FORMAT": "RGB",
            "MIN_SIZE_TRAIN": 600,
            "MIN_SIZE_TEST": 600,
            "MAX_SIZE": 1333,
            "RANDOM_FLIP": "horizontal",
            "PAD_DIVISOR": 32,
            "TEACHER_OFFLINE": {
                "PIXEL_MEAN": [0.48145466, 0.4578275, 0.40821073],
                "PIXEL_STD": [0.26862954, 0.26130258, 0.27577711],
            },
            "TEACHER_CLOUD": {
                "MIN_SIZE_TEST": 600,
                "MAX_SIZE_TEST": 1333,
                "NORM": [[0.485, 0.456, 0.406], [0.229, 0.224, 0.225]],
                # optional extra collection views ('' | 'ZOOM' | 'AUG' |
                # 'ZOOM&AUG' — OFF in the paper, gdino_processor.py:189)
                "COLLECT_AUG": "",
                "MIN_CENTER_ZOOM_SIZE": 320,
            },
        },
        "DATASETS": {
            "TRAIN_UNLABEL": [],
            "TEST": [],
            "STYLE_NAME": "",
            "ROOT": os.environ.get("DETECTRON2_DATASETS", "datasets"),
            # user-registered VOC datasets:
            # [{NAME, DIRNAME, SPLIT, CLASSES, EXT}]
            "CUSTOM": [],
        },
        "DATALOADER": {"NUM_WORKERS": 2},
        "SOLVER": {
            "BASE_LR": 0.001,
            "MOMENTUM": 0.9,
            "NESTEROV": False,
            "WEIGHT_DECAY": 0.0001,
            "LR_SCHEDULER_NAME": "WarmupTwoStageMultiStepLR",
            "STEPS": [40000, 45000, 60000],
            "FACTOR_LIST": [1, 0.1, 0.5, 0.1],
            "GAMMA": 0.1,
            "MAX_ITER": 65000,
            "WARMUP_ITERS": 400,
            "WARMUP_FACTOR": 0.001,
            "IMG_PER_BATCH_UNLABEL": 3,
            # detectron2 auto_scale_workers reference size: 0 = off.
            # When set, trainers rescale batch/LR/schedule by
            # workers/REFERENCE_WORLD_SIZE, the workers being the
            # process group's ranks (engine/base.py num_workers).
            "REFERENCE_WORLD_SIZE": 0,
            "CHECKPOINT_PERIOD": 1000,
            "PER_MODULE_PARAM_WEIGHT": [{}],
            "CLIP_GRADIENTS": {"ENABLED": False, "CLIP_VALUE": 1.0},
        },
        "CLOUD": {
            "Trainer": "",
            "BURN_UP_STEP": 45000,
            "PROTOTYPE_UPDATE_START": 5000,
            "OFFLINE_TEACHER_UPDATE_ITER": 1,
            "EMA_KEEP_RATE_OFFLINE": 0.9996,
            "PROTOTYPE_UPDATE_WEIGHT": 0.9996,
            "UPDATE_BACKBONE": True,
            "ADD_PROMPT_NUM": 4,
            "CLS_B_THRESH": 0.7,
            "NMS_METHOD": "ms",
            "LOSS_TYPE": "MILCrossEntropy",
            "BG_TRAIN": True,
            "CLASSES_WEIGHT": [],
            "LOSS_BOX_REG_WEIGHT": 1.0,
            "LOSS_BOX_REG_OFFLINE_WEIGHT": 1.0,
            "LOSS_BOX_REG_ONLINE_WEIGHT": 1.0,
            "LOSS_CLS_WEIGHT": 1.0,
            "LOSS_TEXT_ALIGN_WEIGHT": 10.0,
            "LOSS_CLS_B_WEIGHT": 0.1,
            "LOSS_DISTILLATION_WEIGHT": 0.1,
            "TEACHER_CLOUD": {
                "RPN_SEPARATE_COLLECT": False,
                "RPN_THRESH": 0.25,
                "RCNN_THRESH": 0.25,
                "COLLECT_NMS_THRESH": 0.6,
                "ZOOM_MATCHER_THRESH": 0.6,
            },
            "MATCHER": {"IOU_THRESHOLDS": 0.5},
        },
        "TEST": {
            "EVAL_PERIOD": 1000,
            "DETECTIONS_PER_IMAGE": 100,
            "EVALUATOR": "VOCeval",
            "EXPECTED_RESULTS": [],
        },
        # TPU-native additions: static capacities + mesh layout
        "TPU": {
            "COMPUTE_DTYPE": "bfloat16",
            "IMAGE_HW": [608, 1216],          # padded train/test canvas
            "CAP_TEACHER": 128,               # cached/teacher dets per image
            "CAP_A": 64, "CAP_B": 32, "CAP_C": 64,
            "MESH": {"DATA": -1},             # -1 = all devices on data axis
            # serving: dynamic-int8 convs at inference (Int8Conv); training
            # numerics are never affected. Measure with tools/bench_serving.
            "INT8_INFERENCE": False,
            # dynamic-int8 convs for the TEACHER_REFRESH_EPOCHS
            # collection pass only (pure inference; needs its own A/B —
            # validate_cached_teacher.py --mode refresh_int8)
            "INT8_COLLECT": False,
            # dynamic-int8 TRAINING compute for the res5 tower (int8 fwd
            # + int8 dgrad + int8 wgrad, ops/qconv.py): the only
            # mathematical path past the bf16 FLOP ceiling (BENCH.md).
            # Semantic knob — ships only with a fixture-v3 A/B artifact
            # (validate_cached_teacher.py --mode int8train)
            "INT8_TRAIN": False,
            # with INT8_TRAIN: quantize the weight-gradient conv too
            # (True = full int8, the max-rate variant) or keep it
            # exact (False = int8 fwd+dgrad only — the optimizer sees
            # the plain conv's weight gradient bit-exactly; the
            # fallback variant when the full-int8 A/B shows an AP
            # cost; --mode int8train_wx)
            "INT8_TRAIN_WGRAD": True,
            # with INT8_TRAIN: activation/gradient scale granularity.
            # "tensor" = one dynamic scale per tensor (the variant the
            # int8train/int8train_wx A/Bs measured at ~-1 AP50 —
            # attributed to outlier ROI crops setting the step for all
            # ~512 crops); "sample" = one scale per batch element (per
            # ROI crop in res5), which factors EXACTLY out of the
            # fwd/dgrad contractions and implies the exact wgrad
            # (per-sample scales cannot leave the wgrad's contracted
            # batch dim). Adjudicated by --mode int8train_ps.
            "INT8_TRAIN_SCALE": "tensor",
            # with INT8_TRAIN: quantize the input-gradient (dgrad) conv
            # (True = the standard recipe). False = int8 FORWARD only,
            # exact dgrad+wgrad — the most conservative staged probe
            # (--mode int8train_fo), isolating forward-activation
            # quantization from gradient quantization entirely.
            "INT8_TRAIN_DGRAD": True,
            # dynamic-int8 RoIAlign (ops/roi_align.roi_align_int8): both
            # pooling contractions on the int8 MXU, s8 intermediate
            # (halves the 1.9 GB/step RoIAlign bandwidth of the int8
            # training step). Straight-through exact backward. Semantic
            # knob — ships only with its own fixture A/B artifact.
            "INT8_ROI": False,
            # step_two teacher-refresh period in epochs (0 = off = exact
            # parity): predictions from a batched collection pass every N
            # epochs instead of a per-step teacher tower. Staleness
            # approximation, A/B PASS on fixture v3
            # (bench_artifacts/ab_refresh_v3_s8.json) — shipped at 4 in
            # foggy_fast.yaml; 0 in the parity recipe.
            "TEACHER_REFRESH_EPOCHS": 0,
        },
    })


def load_config(path: Optional[str] = None,
                opts: Optional[List[str]] = None) -> CfgNode:
    cfg = default_config()
    if path:
        cfg.merge_from_file(path)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg
