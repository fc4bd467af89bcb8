"""Exact ball query — plain PyTorch version of csrc/ball_query.cu.

Counterpart of tpu3dsad/ops/xla/ball_query.py (exact tier): for each
center, the first K points in index order with elementwise fp32
d² = (dx*dx + dy*dy) + dz*dz strictly below r²; slots past the hit count
repeat the first hit; an empty ball gives all zeros; cnt = min(hits, K);
nsample may exceed N.

First-K-in-order selection without sorting: each in-ball point scores
N - index, and top-k of the scores is exactly ascending scan order.

r² is the fp32 rounding of the double radius*radius, which is what the
reference compares with (a Python float meeting an fp32 array).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dsad_torch.ops.args import check_ball_query

# keep the [B, M_chunk, N] distance slab under 2^28 elements (~1 GB fp32);
# beyond that, centers run in serial chunks, as in the reference
_SLAB_LIMIT = 1 << 28


def radius_sq(radius: float) -> float:
    """The fp32 threshold the reference compares d² with."""
    return float(np.float32(float(radius) * float(radius)))


def _slab(xyz, centers, valid, r2, nsample):
    N = xyz.shape[1]
    dx = centers[:, :, None, 0] - xyz[:, None, :, 0]
    dy = centers[:, :, None, 1] - xyz[:, None, :, 1]
    dz = centers[:, :, None, 2] - xyz[:, None, :, 2]
    within = ((dx * dx + dy * dy + dz * dz) < r2) & valid[:, None, :]
    rank = torch.arange(N, dtype=torch.int32, device=xyz.device)
    score = torch.where(within, N - rank, 0)  # distinct and positive on hits
    top = score.topk(min(nsample, N), dim=-1).values  # descending = scan order
    if top.shape[-1] < nsample:
        top = torch.nn.functional.pad(top, (0, nsample - top.shape[-1]))
    hit = top > 0
    idx = torch.where(hit, N - top, 0)
    idx = torch.where(hit, idx, idx[..., :1]).int()  # pad with first hit
    cnt = within.sum(-1).clamp_max(nsample).int()
    return idx, cnt


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               nsample: int, mask: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """xyz [B,N,3], centers [B,M,3] -> (idx [B,M,K] int32, cnt [B,M] int32)."""
    check_ball_query(xyz, centers, nsample, mask)
    B, N, _ = xyz.shape
    M = centers.shape[1]
    xyz, centers = xyz.float(), centers.float()
    valid = (torch.ones(B, N, dtype=torch.bool, device=xyz.device)
             if mask is None else mask.bool())
    r2 = radius_sq(radius)
    chunk = max(1, _SLAB_LIMIT // max(B * N, 1))
    parts = [_slab(xyz, centers[:, s:s + chunk], valid, r2, nsample)
             for s in range(0, M, chunk)]
    return (torch.cat([p[0] for p in parts], 1),
            torch.cat([p[1] for p in parts], 1))
