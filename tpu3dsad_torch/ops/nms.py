"""Shape-static class-aware NMS (tpu3dsad/ops/nms.py): 3D axis-aligned,
bird's-eye-view and oriented.

Greedy suppression over a fixed K = num_proposals candidates: order by a
stable argsort of -score (invalid boxes at -inf score, so last), keep a
candidate if it is valid and not yet suppressed, then suppress every box
whose IoU with it exceeds the threshold. Class-aware NMS translates each box
by class_id × span, with span taken over the whole batch, so boxes of
different classes never overlap.
"""

from __future__ import annotations

import torch

from tpu3dsad_torch.ops.boxes import aabb_iou_3d, oriented_bev_iou


def nms_aabb(box_min, box_max, scores, valid, iou_thresh: float,
             sem_cls=None) -> torch.Tensor:
    """box_min/max [B,K,3], scores [B,K], valid [B,K] -> keep [B,K] bool."""
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
    scores with (eval.use_oriented_nms). Class-aware, it shifts x alone."""
    if sem_cls is not None:
        span = corners[..., 0].max() - corners[..., 0].min() + 1.0
        shift = sem_cls.to(corners.dtype) * span  # [B,K]
        corners = torch.cat([corners[..., :1] + shift[..., None, None],
                             corners[..., 1:]], -1)
    iou = oriented_bev_iou(corners, corners)  # [B,K,K]
    return _greedy_suppress(iou, scores, valid, iou_thresh)


def _greedy_suppress(iou, scores, valid, iou_thresh):
    """Greedy NMS given a [B,K,K] IoU matrix, walked in score order.

    Works in sorted coordinates: row i of `over` is the set the i-th best
    candidate would suppress (never itself), so each step is one row read."""
    B, K = scores.shape
    order = torch.argsort(-torch.where(valid, scores, -torch.inf), dim=-1,
                          stable=True)
    rows = torch.arange(B, device=scores.device)[:, None]
    over = iou[rows[..., None], order[:, :, None], order[:, None, :]] > iou_thresh
    over &= ~torch.eye(K, dtype=torch.bool, device=scores.device)
    valid_sorted = valid.gather(1, order)
    suppressed = torch.zeros(B, K, dtype=torch.bool, device=scores.device)
    keep_sorted = torch.zeros(B, K, dtype=torch.bool, device=scores.device)
    for i in range(K):
        kept = valid_sorted[:, i] & ~suppressed[:, i]
        keep_sorted[:, i] = kept
        suppressed |= over[:, i] & kept[:, None]
    keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    return keep & valid
