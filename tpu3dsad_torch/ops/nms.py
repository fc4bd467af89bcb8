"""Shape-static class-aware NMS (tpu3dsad/ops/nms.py): 3D axis-aligned,
bird's-eye-view and oriented.

Greedy suppression over a fixed K = num_proposals candidates: order by a
stable argsort of -score (invalid boxes at -inf score, so last), keep a
candidate if it is valid and not yet suppressed, then suppress every box
whose IoU with it exceeds the threshold. Class-aware NMS translates each box
by class_id × span, with span taken over the whole batch, so boxes of
different classes never overlap.

Each flavour computes its IoU matrix (the span "parse.iou"), the
axis-aligned ones in torch, the oriented one by the custom op
tpu3dsad_torch::oriented_bev_iou (ops/library.py: one launch of
csrc/iou.cu on a CUDA tensor), and hands it to one walk, the custom op
tpu3dsad_torch::greedy_suppress: one launch of csrc/nms.cu on a CUDA
tensor. On the CPU or inside ops.use_impl("plain") both ops run their
plain versions (ops/plain/iou.py, ops/plain/nms.py).
"""

from __future__ import annotations

import torch

from tpu3dsad_torch.ops import library as _library
from tpu3dsad_torch.ops.boxes import aabb_iou_3d, oriented_bev_iou
from tpu3dsad_torch.utils import trace


def nms_aabb(box_min, box_max, scores, valid, iou_thresh: float,
             sem_cls=None) -> torch.Tensor:
    """box_min/max [B,K,3], scores [B,K], valid [B,K] -> keep [B,K] bool."""
    with trace.span("parse.iou"):
        if sem_cls is not None:
            span = box_max.max() - box_min.min() + 1.0
            shift = (sem_cls.to(box_min.dtype) * span)[..., None]
            box_min = box_min + shift
            box_max = box_max + shift
        iou = aabb_iou_3d(box_min, box_max, box_min, box_max)  # [B,K,K]
    return _greedy_suppress(iou, scores, valid, iou_thresh)


def nms_bev(box_min, box_max, scores, valid, iou_thresh: float,
            sem_cls=None) -> torch.Tensor:
    """Bird's-eye-view NMS (eval.use_3d_nms=False): the suppression IoU
    ignores the z extent. Same inputs as nms_aabb."""
    # z collapsed to one unit slab makes the 3D IoU the 2D BEV IoU
    z0 = torch.zeros_like(box_min[..., 2:3])
    bmin = torch.cat([box_min[..., :2], z0], -1)
    bmax = torch.cat([box_max[..., :2], z0 + 1.0], -1)
    return nms_aabb(bmin, bmax, scores, valid, iou_thresh, sem_cls=sem_cls)


def nms_oriented(corners, scores, valid, iou_thresh: float,
                 sem_cls=None) -> torch.Tensor:
    """NMS by the oriented BEV IoU over [B,K,8,3] corners, the IoU that AP
    scores with (eval.use_oriented_nms). Class-aware, it shifts x alone.

    Each row i of the IoU is computed with every box moved by box i's
    first corner, so the float32 clip works on coordinates of a few meters
    and not on the scene's tens: on boxes 0.1 m across (3DSSD's size
    floor) 50 m out, the scene frame's rounding moved an IoU by up to 6e-3
    from its exact value, the pair's frame by 3e-7 (PERF.md §7). One op
    call over B * K clouds of one row each."""
    with trace.span("parse.iou"):
        if sem_cls is not None:
            span = corners[..., 0].max() - corners[..., 0].min() + 1.0
            shift = sem_cls.to(corners.dtype) * span  # [B,K]
            corners = torch.cat([corners[..., :1] + shift[..., None, None],
                                 corners[..., 1:]], -1)
        B, K = corners.shape[:2]
        origin = corners[:, :, None, :1, :]  # [B,K,1,1,3]
        rows = (corners[:, :, None] - origin).reshape(B * K, 1, 8, 3)
        cols = (corners[:, None] - origin).reshape(B * K, K, 8, 3)
        iou = oriented_bev_iou(rows, cols).reshape(B, K, K)
    return _greedy_suppress(iou, scores, valid, iou_thresh)


def _greedy_suppress(iou, scores, valid, iou_thresh):
    """keep [B,K] bool of the greedy walk over iou [B,K,K] (bools: nothing
    to differentiate)."""
    return _library.greedy_suppress(iou.detach(), scores.detach(), valid,
                                    float(iou_thresh))
