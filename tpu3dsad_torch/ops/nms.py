"""Shape-static class-aware 3D NMS (tpu3dsad/ops/nms.py:21-40, 81-104).

Greedy suppression over a fixed K = num_proposals candidates: order by a
stable argsort of -score (invalid boxes at -inf score, so last), keep a
candidate if it is valid and not yet suppressed, then suppress every box
whose IoU with it exceeds the threshold. Class-aware NMS translates each box
by class_id × span, with span taken over the whole batch, so boxes of
different classes never overlap. nms_bev / nms_oriented wait (ROADMAP A5b).
"""

from __future__ import annotations

import torch

from tpu3dsad_torch.ops.boxes import aabb_iou_3d


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
