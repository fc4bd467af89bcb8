"""Prediction parsing (tpu3dsad/eval/parse.py): decode -> threshold ->
NMS on the device (`parse_predictions`; 3DSSD's anchor-free boxes by
`parse_ssd3d`, Group-Free 3D's by `parse_groupfree`; `make_parser` picks
one by model.name), then on the host the per-scene lists that AP scores
(`predictions_to_lists`, `parse_groundtruths`), in numpy."""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu3dsad_torch import ops
from tpu3dsad_torch.config import EvalConfig
from tpu3dsad_torch.models.decode import predicted_boxes
from tpu3dsad_torch.ops.boxes import _CORNER_SIGNS, box_corners, corners_to_aabb
from tpu3dsad_torch.ops.nms import nms_aabb, nms_bev, nms_oriented
from tpu3dsad_torch.utils import trace


def parse_predictions(end_points, mean_sizes, num_heading_bins: int,
                      eval_cfg: EvalConfig):
    """-> dict of fixed-shape tensors describing the final detections.

    keep [B,P] marks NMS survivors above the objectness threshold: by the
    oriented BEV IoU with eval.use_oriented_nms, else on the axis-aligned
    hulls, in 3D (use_3d_nms) or in BEV."""
    with trace.span("parse.decode"):
        center, size, heading, sem, obj_prob = predicted_boxes(
            end_points, mean_sizes, num_heading_bins)
        corners = box_corners(center, size, heading)  # [B,P,8,3]
        bmin, bmax = corners_to_aabb(corners)
        valid = end_points["proposal_mask"] & (
            obj_prob > eval_cfg.objectness_thresh)
    sem_cls = sem if eval_cfg.cls_nms else None
    with trace.span("parse.nms"):
        if eval_cfg.use_oriented_nms:
            keep = nms_oriented(corners, obj_prob, valid, eval_cfg.nms_iou,
                                sem_cls=sem_cls)
        else:
            nms = nms_aabb if eval_cfg.use_3d_nms else nms_bev
            keep = nms(bmin, bmax, obj_prob, valid, eval_cfg.nms_iou,
                       sem_cls=sem_cls)
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


def parse_ssd3d(end_points, eval_cfg: EvalConfig, max_output: int):
    """3DSSD's boxes (models/ssd3d.py) -> the parsed fields of
    parse_predictions. A box's score (under obj_prob) is the sigmoid of its
    largest class logit, its class that logit's; no objectness. keep [B,P]
    marks the NMS survivors above eval.objectness_thresh, cut to the first
    `max_output` by score (top_scores; 0 keeps them all). NMS is by the
    oriented BEV IoU with eval.use_oriented_nms, computed row by row in the
    row box's frame (ops/nms.py: 3DSSD's 0.1 m size floor makes slivers),
    else by the axis-aligned hulls; class-aware with eval.cls_nms.
    sem_prob is the one-hot of the class, so that a class-wise list scores
    a box by its score."""
    with trace.span("parse.decode"):
        center, size, heading = (end_points[k]
                                 for k in ("center", "size", "heading"))
        logits = end_points["sem_cls_scores"]
        score = torch.sigmoid(logits.amax(-1))
        sem = logits.argmax(-1)
        corners = box_corners(center, size, heading)
        valid = end_points["proposal_mask"] & (
            score > eval_cfg.objectness_thresh)
    sem_cls = sem if eval_cfg.cls_nms else None
    with trace.span("parse.nms"):
        if eval_cfg.use_oriented_nms:
            keep = nms_oriented(corners, score, valid, eval_cfg.nms_iou,
                                sem_cls=sem_cls)
        else:
            bmin, bmax = corners_to_aabb(corners)
            nms = nms_aabb if eval_cfg.use_3d_nms else nms_bev
            keep = nms(bmin, bmax, score, valid, eval_cfg.nms_iou,
                       sem_cls=sem_cls)
        keep = top_scores(keep, score, max_output)
    return {
        "center": center,
        "size": size,
        "heading": heading,
        "sem_cls": sem,
        "obj_prob": score,
        "sem_prob": torch.nn.functional.one_hot(
            sem, logits.shape[-1]).to(score.dtype),
        "corners": corners,
        "keep": keep,
    }


def parse_groupfree(end_points, eval_cfg: EvalConfig, stages: int,
                    min_points: int):
    """Group-Free 3D's boxes (models/groupfree.py) -> the parsed fields of
    parse_predictions, P = stages x candidates of them (mmdet3d's
    GroupFree3DHead.get_bboxes with prediction_stages='last_three' at
    stages 3):

      * the boxes of the last `stages` decoder stages, concatenated stage
        after stage;
      * obj_prob = sigmoid(objectness), sem_prob = softmax(class logits),
        sem_cls its argmax, heading 0;
      * a box is non-empty where more than `min_points` valid input points
        lie in it (ops.box_points: strict faces in x and y, inclusive in
        z; the span parse.box_points);
      * keep [B,P]: the greedy walk over the non-empty boxes by obj_prob,
        class-aware with eval.cls_nms, by the axis-aligned 3D IoU
        (eval.use_3d_nms, else BEV), then obj_prob above
        eval.objectness_thresh."""
    with trace.span("parse.decode"):
        B = end_points["stage_center"].shape[0]
        center, size = (end_points[k][:, -stages:].reshape(B, -1, 3)
                        for k in ("stage_center", "stage_size"))
        obj_prob = torch.sigmoid(
            end_points["stage_obj"][:, -stages:].reshape(B, -1))
        sem_logits = end_points["stage_sem"][:, -stages:]
        sem_prob = torch.softmax(
            sem_logits.reshape(B, -1, sem_logits.shape[-1]), -1)
        sem = sem_prob.argmax(-1)
        heading = torch.zeros_like(obj_prob)
        corners = box_corners(center, size, heading)
        bmin, bmax = corners_to_aabb(corners)
        proposal = end_points["proposal_mask"].repeat(1, stages)
    with trace.span("parse.box_points"):
        counts = ops.box_points(end_points["points"], center, size,
                                mask=end_points["point_mask"])
        valid = proposal & (counts > min_points)
    sem_cls = sem if eval_cfg.cls_nms else None
    with trace.span("parse.nms"):
        nms = nms_aabb if eval_cfg.use_3d_nms else nms_bev
        keep = nms(bmin, bmax, obj_prob, valid, eval_cfg.nms_iou,
                   sem_cls=sem_cls)
        keep = keep & (obj_prob > eval_cfg.objectness_thresh)
    return {
        "center": center,
        "size": size,
        "heading": heading,
        "sem_cls": sem,
        "obj_prob": obj_prob,
        "sem_prob": sem_prob,
        "corners": corners,
        "keep": keep,
    }


def top_scores(keep, score, k: int):
    """keep [B,P] cut to its first k boxes by score, in the walk's order (a
    stable sort of -score: ties to the lower slot); k <= 0 keeps all."""
    P = keep.shape[-1]
    if k <= 0 or k >= P:
        return keep
    order = torch.argsort(-torch.where(keep, score, -torch.inf), dim=-1,
                          stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(P, device=order.device).expand_as(order))
    return keep & (rank < k)


def make_parser(cfg, mean_sizes):
    """parse(end_points) -> the parsed fields of the detector that
    cfg.model.name builds (train_detector.build_detector)."""
    if cfg.model.name == "ssd3d":
        return functools.partial(parse_ssd3d, eval_cfg=cfg.eval,
                                 max_output=cfg.model.ssd3d_max_output)
    if cfg.model.name == "groupfree3d":
        return functools.partial(parse_groupfree, eval_cfg=cfg.eval,
                                 stages=cfg.model.groupfree_stages,
                                 min_points=cfg.model.groupfree_min_points)
    return functools.partial(parse_predictions, mean_sizes=mean_sizes,
                             num_heading_bins=cfg.model.num_heading_bins,
                             eval_cfg=cfg.eval)


def predictions_to_lists(parsed, eval_cfg: EvalConfig, num_classes: int):
    """Host side: parsed fields (numpy) -> per scene a list of
    (class, corners [8,3], score) tuples.

    The conf_thresh gate is on obj_prob alone. With per_class_proposal every
    class of a kept proposal is emitted at score sem_prob[c] * obj_prob,
    class-major then proposal-minor; without it one entry per kept proposal
    at its obj_prob."""
    keep = np.asarray(parsed["keep"])
    corners = np.asarray(parsed["corners"])
    obj = np.asarray(parsed["obj_prob"])
    semp = np.asarray(parsed["sem_prob"])
    sem = np.asarray(parsed["sem_cls"])
    B, P = keep.shape
    gate = keep & (obj > eval_cfg.conf_thresh)  # [B,P]
    if eval_cfg.per_class_proposal:
        scores = obj[:, :, None] * semp[..., :num_classes]  # [B,P,C]
        b_i, c_i, p_i = np.nonzero(
            np.broadcast_to(gate[:, None, :], (B, num_classes, P)))
        s_i = scores[b_i, p_i, c_i]
    else:
        b_i, p_i = np.nonzero(gate)
        c_i = sem[b_i, p_i]
        s_i = obj[b_i, p_i]
    out = [[] for _ in range(B)]
    for b, p, c, s in zip(b_i, p_i, c_i, s_i):
        out[b].append((int(c), corners[b, p], float(s)))
    return out


def _box_corners_np(center, size, heading):
    """numpy twin of ops.boxes.box_corners (same math, same corner order)
    for the host's ground-truth corners."""
    signs = np.asarray(_CORNER_SIGNS, np.float32)
    ext = size[..., None, :] * signs  # [..., 8, 3]
    c, s = np.cos(heading), np.sin(heading)
    x = ext[..., 0] * c[..., None] - ext[..., 1] * s[..., None]
    y = ext[..., 0] * s[..., None] + ext[..., 1] * c[..., None]
    rot = np.stack([x, y, ext[..., 2]], axis=-1)
    return (rot + center[..., None, :]).astype(np.float32)


def parse_groundtruths(batch):
    """Host side: padded ground-truth arrays (numpy) -> per scene a list of
    (class, corners [8,3])."""
    classes = np.asarray(batch["gt_classes"])
    mask = np.asarray(batch["gt_mask"])
    corners = _box_corners_np(np.asarray(batch["gt_centers"]),
                              np.asarray(batch["gt_sizes"]),
                              np.asarray(batch["gt_headings"]))
    return [[(int(classes[b, g]), corners[b, g])
             for g in range(mask.shape[1]) if mask[b, g]]
            for b in range(mask.shape[0])]
