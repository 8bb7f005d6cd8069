"""Detector construction and the inference pipeline (counterparts of
coin_tpu/engine/pipelines.py:23-83,154-191 and coin_tpu/engine/base.py:
27-53,126-152)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from coin_tpu_torch.device import compute_dtype, resolve_device
from coin_tpu_torch.models import roi_heads as rh
from coin_tpu_torch.models import rpn as rpn_lib
from coin_tpu_torch.models.anchors import grid_anchors
from coin_tpu_torch.models.detector import OpenVocabularyRCNN
from coin_tpu_torch.ops import boxes as box_ops
from coin_tpu_torch.structures import Detections


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The inference fields of coin_tpu's PipelineConfig."""
    num_classes: int
    rpn_nms_thresh: float = 0.7
    pre_nms_topk_test: int = 6000
    post_nms_topk_test: int = 1000
    pooler_resolution: int = 14
    test_score_thresh: float = 0.05
    test_nms_thresh: float = 0.5
    test_topk: int = 100
    stride: int = 16


def pipeline_config_from(cfg, num_classes: int) -> PipelineConfig:
    m = cfg.MODEL
    return PipelineConfig(
        num_classes=num_classes,
        rpn_nms_thresh=m.RPN.NMS_THRESH,
        pre_nms_topk_test=m.RPN.PRE_NMS_TOPK_TEST,
        post_nms_topk_test=m.RPN.POST_NMS_TOPK_TEST,
        pooler_resolution=m.ROI_BOX_HEAD.POOLER_RESOLUTION,
        test_score_thresh=m.ROI_HEADS.SCORE_THRESH_TEST,
        test_nms_thresh=m.ROI_HEADS.NMS_THRESH_TEST,
        test_topk=cfg.TEST.DETECTIONS_PER_IMAGE,
    )


def build_detector(cfg, num_classes: int, device="cuda"
                   ) -> OpenVocabularyRCNN:
    """The detector a config describes, on ``device``, in eval mode.

    Raises for the configurations whose code waits for a later slice:
    attention pooling, per-class box regression and int8 serving convs.
    """
    device = resolve_device(device)
    if cfg.MODEL.ROI_HEADS.POOLING_TYPE != "meanpool":
        raise NotImplementedError("POOLING_TYPE attnpool is not ported yet")
    if not cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG:
        raise NotImplementedError("per-class box regression is not ported")
    if cfg.get_path("TPU.INT8_INFERENCE", False):
        raise NotImplementedError("TPU.INT8_INFERENCE is not ported yet")
    model = OpenVocabularyRCNN(
        num_classes=num_classes,
        depth=cfg.MODEL.RESNETS.DEPTH,
        add_prompt_num=cfg.CLOUD.ADD_PROMPT_NUM,
        text_layers=cfg.get_path("TPU.TEXT_LAYERS", 12),
        text_width=cfg.get_path("TPU.TEXT_WIDTH", 512),
        text_heads=cfg.get_path("TPU.TEXT_HEADS", 8),
        compute_dtype=compute_dtype(cfg))
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def anchors_for(images: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    h, w = images.shape[1] // cfg.stride, images.shape[2] // cfg.stride
    return torch.from_numpy(grid_anchors(h, w, cfg.stride)).to(images.device)


def rpn_forward(model: OpenVocabularyRCNN, feats: torch.Tensor,
                images_hw: torch.Tensor, anchors: torch.Tensor,
                cfg: PipelineConfig):
    """RPN head + test-time proposals."""
    obj, deltas = model.rpn(feats)
    proposals = rpn_lib.predict_proposals(
        anchors, obj, deltas, images_hw, cfg.pre_nms_topk_test,
        cfg.post_nms_topk_test, cfg.rpn_nms_thresh)
    return obj, deltas, proposals


def inference(model: OpenVocabularyRCNN, images: torch.Tensor,
              images_hw: torch.Tensor, class_tokens: torch.Tensor,
              cfg: PipelineConfig,
              text_features: Optional[torch.Tensor] = None) -> Detections:
    """Test branch: normalised images (B, H, W, 3) → batched Detections
    in canvas coordinates. ``text_features`` may be passed to skip the
    text tower (it depends on the weights only)."""
    feats = model.features(images)
    anchors = anchors_for(images, cfg)
    _, _, proposals = rpn_forward(model, feats, images_hw, anchors, cfg)
    pooled = model.pool_boxes(feats, proposals.boxes, cfg.pooler_resolution)
    if text_features is None:
        text_features = model.text_features(class_tokens)
    return box_inference(model, pooled, proposals, images_hw, text_features,
                         cfg)


def box_inference(model: OpenVocabularyRCNN, pooled: torch.Tensor,
                  proposals: Detections, images_hw: torch.Tensor,
                  text_features: torch.Tensor,
                  cfg: PipelineConfig) -> Detections:
    """Pooled proposal features → classified, decoded, NMS'd detections."""
    scores, deltas, _ = model.predict(pooled, text_features)
    probs = torch.softmax(scores, dim=-1)
    boxes = box_ops.decode_deltas(proposals.boxes, deltas,
                                  rh.BOX_REG_WEIGHTS)
    return rh.fast_rcnn_inference(boxes, probs, proposals.valid, images_hw,
                                  cfg.test_score_thresh, cfg.test_nms_thresh,
                                  cfg.test_topk)
