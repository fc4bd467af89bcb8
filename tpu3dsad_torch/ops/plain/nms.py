"""Greedy NMS walk — plain PyTorch version of csrc/nms.cu.

The reference's _greedy_suppress (tpu3dsad/ops/nms.py:81-104), an XLA
fori_loop there, is a Python loop of K steps here, 4-5 launches each on a
CUDA tensor.
"""

from __future__ import annotations

import torch

from tpu3dsad_torch.ops.args import check_nms


def greedy_suppress(iou, scores, valid, iou_thresh):
    """Greedy NMS given a [B,K,K] IoU matrix, walked in score order.

    Works in sorted coordinates: row i of `over` is the set the i-th best
    candidate would suppress (never itself), so each step is one row read."""
    check_nms(iou, scores, valid)
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
