"""Detector construction, the pipeline configuration, the oracle's
supervised losses and the inference pipeline with its res5-crop sharing
(counterparts of coin_tpu/engine/pipelines.py:23-191 and
coin_tpu/engine/base.py:27-70,126-152)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from coin_tpu_torch.device import compute_dtype, resolve_device
from coin_tpu_torch.models import roi_heads as rh
from coin_tpu_torch.models import rpn as rpn_lib
from coin_tpu_torch.models.anchors import grid_anchors
from coin_tpu_torch.models.detector import OpenVocabularyRCNN
from coin_tpu_torch.ops import boxes as box_ops
from coin_tpu_torch.ops import losses as L
from coin_tpu_torch.ops.dedup import self_cluster_index
from coin_tpu_torch.structures import Detections


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """coin_tpu's PipelineConfig (coin_tpu/engine/pipelines.py:23-66)."""
    num_classes: int
    # RPN
    rpn_batch_size: int = 256
    rpn_positive_fraction: float = 0.5
    rpn_thresholds: Tuple[float, float] = (0.3, 0.7)
    rpn_nms_thresh: float = 0.7
    pre_nms_topk_train: int = 6000
    post_nms_topk_train: int = 1000
    pre_nms_topk_test: int = 6000
    post_nms_topk_test: int = 1000
    # ROI
    roi_batch_size: int = 512
    roi_positive_fraction: float = 0.25
    roi_iou_threshold: float = 0.5
    pooler_resolution: int = 14
    # test
    test_score_thresh: float = 0.05
    test_nms_thresh: float = 0.5
    test_topk: int = 100
    # losses (CLOUD.* in the reference config)
    bg_weight: float = 1.0
    loss_type: str = "MILCrossEntropy"
    classes_weight: Optional[Tuple[float, ...]] = None
    bg_train: bool = True
    stride: int = 16
    cls_agnostic_bbox_reg: bool = True
    # res5-crop sharing (TPU.TEACHER_SHARE_CROPS): pool only the IoU-cluster
    # representatives, at most this many per image; 0 = off
    share_crops_budget: int = 0
    share_crops_thresh: float = 0.9
    # the fast head (TPU.TEACHER_FAST_HEAD): res5 once over the map, then
    # RoIAlign of the res5 map (OpenVocabularyRCNN.pool_boxes_fast)
    fast_head: bool = False


def pipeline_config_from(cfg, num_classes: int) -> PipelineConfig:
    m = cfg.MODEL
    cw = cfg.CLOUD.CLASSES_WEIGHT
    return PipelineConfig(
        num_classes=num_classes,
        rpn_batch_size=m.RPN.BATCH_SIZE_PER_IMAGE,
        rpn_positive_fraction=m.RPN.POSITIVE_FRACTION,
        rpn_thresholds=tuple(m.RPN.IOU_THRESHOLDS),
        rpn_nms_thresh=m.RPN.NMS_THRESH,
        pre_nms_topk_train=m.RPN.PRE_NMS_TOPK_TRAIN,
        post_nms_topk_train=m.RPN.POST_NMS_TOPK_TRAIN,
        pre_nms_topk_test=m.RPN.PRE_NMS_TOPK_TEST,
        post_nms_topk_test=m.RPN.POST_NMS_TOPK_TEST,
        roi_batch_size=m.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
        roi_positive_fraction=m.ROI_HEADS.POSITIVE_FRACTION,
        roi_iou_threshold=m.ROI_HEADS.IOU_THRESHOLDS[0],
        pooler_resolution=m.ROI_BOX_HEAD.POOLER_RESOLUTION,
        test_score_thresh=m.ROI_HEADS.SCORE_THRESH_TEST,
        test_nms_thresh=m.ROI_HEADS.NMS_THRESH_TEST,
        test_topk=cfg.TEST.DETECTIONS_PER_IMAGE,
        bg_weight=cw[-1] if cw else 1.0,
        loss_type=cfg.CLOUD.LOSS_TYPE,
        classes_weight=tuple(cw) if cw else None,
        bg_train=cfg.CLOUD.BG_TRAIN,
        cls_agnostic_bbox_reg=m.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG,
    )


def loss_weights_from(cfg) -> Dict[str, float]:
    c = cfg.CLOUD
    return {
        "loss_box_reg": c.LOSS_BOX_REG_WEIGHT,
        "loss_box_reg_offline": c.LOSS_BOX_REG_OFFLINE_WEIGHT,
        "loss_box_reg_online": c.LOSS_BOX_REG_ONLINE_WEIGHT,
        "loss_cls": c.LOSS_CLS_WEIGHT,
        "loss_text_align": c.LOSS_TEXT_ALIGN_WEIGHT,
        "loss_distillation": c.LOSS_DISTILLATION_WEIGHT,
        "loss_cls_b": c.LOSS_CLS_B_WEIGHT,
        "loss_rpn_distillation": c.LOSS_DISTILLATION_WEIGHT,
        "loss_rpn_cls": cfg.MODEL.RPN.LOSS_WEIGHT,
        "loss_rpn_loc": (cfg.MODEL.RPN.BBOX_REG_LOSS_WEIGHT
                         * cfg.MODEL.RPN.LOSS_WEIGHT),
    }


def int8_train_mode(cfg) -> int:
    """``quant_train_res5`` from the TPU.INT8_TRAIN* knobs
    (coin_tpu/engine/base.py:142-150): 0 off; 4 int8 forward only
    (INT8_TRAIN_DGRAD false); 3 per-sample scales (INT8_TRAIN_SCALE
    sample); 1 full int8 (INT8_TRAIN_WGRAD true); 2 exact wgrad."""
    g = cfg.get_path
    if not g("TPU.INT8_TRAIN", False):
        return 0
    if not g("TPU.INT8_TRAIN_DGRAD", True):
        return 4
    if g("TPU.INT8_TRAIN_SCALE", "tensor") == "sample":
        return 3
    return 1 if g("TPU.INT8_TRAIN_WGRAD", True) else 2


def build_detector(cfg, num_classes: int, device="cuda"
                   ) -> OpenVocabularyRCNN:
    """The detector a config describes, on ``device``, in eval mode, as
    the JAX package's trainers build it: its res5 trains in int8 under
    ``TPU.INT8_TRAIN`` (:func:`int8_train_mode`). ``TPU.INT8_INFERENCE``
    is the evaluator's (``DetectorTrainerBase.evaluate`` takes the int8
    clone).

    ``TPU.INT8_ROI`` makes every ``pool_boxes`` run the int8 RoIAlign
    (K5; ``quant_roi``), as ``coin_tpu/engine/base.py`` builds it.
    ``MODEL.ROI_HEADS.POOLING_TYPE`` picks the mean pool or CLIP's
    attention pool (``attnpool``) after res5.
    ``MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG`` false gives the box
    predictor a column of 4 deltas per class.
    """
    device = resolve_device(device)
    model = OpenVocabularyRCNN(
        num_classes=num_classes,
        depth=cfg.MODEL.RESNETS.DEPTH,
        add_prompt_num=cfg.CLOUD.ADD_PROMPT_NUM,
        text_layers=cfg.get_path("TPU.TEXT_LAYERS", 12),
        text_width=cfg.get_path("TPU.TEXT_WIDTH", 512),
        text_heads=cfg.get_path("TPU.TEXT_HEADS", 8),
        compute_dtype=compute_dtype(cfg),
        quant_train_res5=int8_train_mode(cfg),
        quant_roi=cfg.get_path("TPU.INT8_ROI", False),
        pooling=cfg.MODEL.ROI_HEADS.POOLING_TYPE,
        box_reg_classes=(1 if cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG
                         else num_classes))
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def anchors_for(images: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    h, w = images.shape[1] // cfg.stride, images.shape[2] // cfg.stride
    return torch.from_numpy(grid_anchors(h, w, cfg.stride)).to(images.device)


def rpn_forward(model: OpenVocabularyRCNN, feats: torch.Tensor,
                images_hw: torch.Tensor, anchors: torch.Tensor,
                cfg: PipelineConfig, train: bool = False):
    """RPN head + proposals (the train or test top-k), predicted from the
    detached logits and deltas."""
    obj, deltas = model.rpn(feats)
    proposals = rpn_lib.predict_proposals(
        anchors, obj.detach(), deltas.detach(), images_hw,
        cfg.pre_nms_topk_train if train else cfg.pre_nms_topk_test,
        cfg.post_nms_topk_train if train else cfg.post_nms_topk_test,
        cfg.rpn_nms_thresh)
    return obj, deltas, proposals


def oracle_train_losses(model: OpenVocabularyRCNN, images: torch.Tensor,
                        images_hw: torch.Tensor, gt: Detections,
                        class_tokens: torch.Tensor,
                        rpn_priorities: torch.Tensor,
                        roi_priorities: torch.Tensor,
                        cfg: PipelineConfig) -> Dict[str, torch.Tensor]:
    """The oracle's supervised branch: Faster R-CNN's losses with the
    cosine classifier on the ground truth ``gt`` (B, G) alone. The RPN
    learns the anchors labelled against ``gt``; 512 (``roi_batch_size``)
    proposals an image are sampled against it, the gt boxes among the
    candidates; CE on the offline class clipped to [0, C] over the
    sampled rows and box regression on the offline classes. Unweighted.
    ``rpn_priorities`` (B, 2, anchors) and ``roi_priorities``
    (B, 2, P + G) are the subsampling draws."""
    feats = model.features(images)
    anchors = anchors_for(images, cfg)
    obj, rpn_deltas, proposals = rpn_forward(model, feats, images_hw,
                                             anchors, cfg, train=True)
    targets = rpn_lib.label_anchors(
        anchors, gt, None, rpn_priorities, cfg.rpn_batch_size,
        cfg.rpn_positive_fraction, cfg.rpn_thresholds)
    losses = rpn_lib.rpn_losses(anchors, obj, rpn_deltas, targets,
                                cfg.rpn_batch_size)
    sp = rh.sample_proposals(
        proposals, gt, None, None, cfg.num_classes, roi_priorities,
        cfg.roi_batch_size, cfg.roi_positive_fraction, cfg.roi_iou_threshold)
    pooled = model.pool_boxes(feats, sp.boxes, cfg.pooler_resolution)
    text = model.text_features(class_tokens)
    scores, deltas, _ = model.predict(pooled, text)

    flat = lambda a: a.reshape((-1,) + tuple(a.shape[2:]))
    sp_f = rh.SampledProposals(*[flat(x) for x in sp])
    labels = sp_f.cls_offline.long().clamp(0, cfg.num_classes)
    logp = torch.log_softmax(flat(scores), dim=-1)
    ce = -torch.gather(logp, 1, labels[:, None])[:, 0]
    losses["loss_cls"] = L.masked_mean(ce, sp_f.group != rh.GROUP_PAD)
    losses["loss_box_reg"] = rh.box_reg_loss(
        sp_f, flat(deltas), cfg.num_classes, use_online_classes=False)
    return losses


def shared_pool(model: OpenVocabularyRCNN, feats: torch.Tensor,
                boxes: torch.Tensor, valid: torch.Tensor,
                cfg: PipelineConfig) -> torch.Tensor:
    """Pool res5 features for the cluster representatives only (boxes at
    IoU >= ``share_crops_thresh`` share one crop; K11 finds them), at most
    ``share_crops_budget`` per image, and hand each member its
    representative's: boxes (B, N, 4), valid (B, N) → (B, N, D). Exact for
    IoU = 1 duplicates, approximate within a cluster otherwise."""
    keep, rep = self_cluster_index(boxes, valid, cfg.share_crops_thresh)
    # representatives to the front, stably; inv maps a row to its place
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    inv = torch.argsort(order, dim=1)
    rep_pos = torch.gather(inv, 1, rep).clamp_max(cfg.share_crops_budget - 1)
    first = order[:, :cfg.share_crops_budget]
    rep_boxes = torch.gather(boxes, 1, first[..., None].expand(-1, -1, 4))
    pooled = model.pool_boxes(feats, rep_boxes, cfg.pooler_resolution)
    return torch.gather(pooled, 1, rep_pos[..., None].expand(
        -1, -1, pooled.shape[-1]))


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
    if cfg.fast_head:
        pooled = model.pool_boxes_fast(feats, proposals.boxes)
    elif cfg.share_crops_budget:
        pooled = shared_pool(model, feats, proposals.boxes, proposals.valid,
                             cfg)
    else:
        pooled = model.pool_boxes(feats, proposals.boxes,
                                  cfg.pooler_resolution)
    if text_features is None:
        text_features = model.text_features(class_tokens)
    return box_inference(model, pooled, proposals, images_hw, text_features,
                         cfg)


def box_inference(model: OpenVocabularyRCNN, pooled: torch.Tensor,
                  proposals: Detections, images_hw: torch.Tensor,
                  text_features: torch.Tensor,
                  cfg: PipelineConfig) -> Detections:
    """Pooled proposal features → classified, decoded, NMS'd detections;
    per-class deltas decode to a box per (proposal, class)."""
    scores, deltas, _ = model.predict(pooled, text_features)
    probs = torch.softmax(scores, dim=-1)
    if deltas.shape[-1] == 4:
        boxes = box_ops.decode_deltas(proposals.boxes, deltas,
                                      rh.BOX_REG_WEIGHTS)
    else:  # (B, R, C, 4) candidate boxes
        boxes = box_ops.decode_deltas(
            proposals.boxes[..., None, :],
            deltas.reshape(deltas.shape[:-1] + (-1, 4)), rh.BOX_REG_WEIGHTS)
    return rh.fast_rcnn_inference(boxes, probs, proposals.valid, images_hw,
                                  cfg.test_score_thresh, cfg.test_nms_thresh,
                                  cfg.test_topk)
