"""Gather and the grouping epilogue — plain PyTorch (counterpart of
tpu3dsad/ops/xla/group.py).

The gather is torch indexing, as the reference's is an XLA gather; the ops
API wraps it with the scatter_rows backward (ops.gather / ops.group).
"""

from __future__ import annotations

import torch


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B,N,C], idx [B,M] -> [B,M,C]."""
    C = points.shape[-1]
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, C))


def group_epilogue(gathered, centers, cnt, radius, nsample, *,
                   has_features: bool, use_xyz: bool = True,
                   normalize_xyz: bool = False):
    """Center-relative (optionally radius-normalized) xyz, the slot < cnt
    mask, and the use_xyz feature concat.

    gathered [B,M,K,3+C] (xyz first), centers [B,M,3], cnt [B,M].
    Returns (grouped, group_mask)."""
    grouped_xyz = gathered[..., :3] - centers[:, :, None, :]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    slot = torch.arange(nsample, dtype=torch.int32, device=cnt.device)
    group_mask = slot < cnt[:, :, None]
    if not has_features:
        grouped = grouped_xyz
    elif use_xyz:
        grouped = torch.cat([grouped_xyz, gathered[..., 3:]], -1)
    else:
        grouped = gathered[..., 3:]
    return grouped, group_mask
