"""Prediction parsing: decode -> threshold -> NMS, on the device
(tpu3dsad/eval/parse.py:20-67)."""

from __future__ import annotations

import torch

from tpu3dsad_torch.config import EvalConfig
from tpu3dsad_torch.models.decode import predicted_boxes
from tpu3dsad_torch.ops.boxes import box_corners, corners_to_aabb
from tpu3dsad_torch.ops.nms import nms_aabb


def parse_predictions(end_points, mean_sizes, num_heading_bins: int,
                      eval_cfg: EvalConfig):
    """-> dict of fixed-shape tensors describing the final detections.

    keep [B,P] marks NMS survivors above the objectness threshold. Only the
    axis-aligned 3D NMS is ported (use_3d_nms=True, use_oriented_nms=False,
    the defaults); the BEV and oriented variants wait (ROADMAP A5b)."""
    if eval_cfg.use_oriented_nms or not eval_cfg.use_3d_nms:
        raise NotImplementedError(
            "nms_oriented / nms_bev are not ported yet (ROADMAP A5b); use "
            "eval.use_3d_nms=True, eval.use_oriented_nms=False")
    center, size, heading, sem, obj_prob = predicted_boxes(
        end_points, mean_sizes, num_heading_bins)
    corners = box_corners(center, size, heading)  # [B,P,8,3]
    bmin, bmax = corners_to_aabb(corners)
    valid = end_points["proposal_mask"] & (obj_prob > eval_cfg.objectness_thresh)
    keep = nms_aabb(bmin, bmax, obj_prob, valid, eval_cfg.nms_iou,
                    sem_cls=sem if eval_cfg.cls_nms else None)
    return {
        "center": center,
        "size": size,
        "heading": heading,
        "sem_cls": sem,
        "obj_prob": obj_prob,
        "sem_prob": torch.softmax(end_points["sem_cls_scores"], -1),
        "corners": corners,
        "keep": keep,
    }
