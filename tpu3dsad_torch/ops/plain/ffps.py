"""Feature-space furthest point sampling (3DSSD's F-FPS) — plain PyTorch
version of csrc/ffps.cu.

FPS over each point's whole vector [B, N, D] (xyz and its features): start
at index 0, then npoint-1 rounds of "update the running min squared
distance to the chosen set, pick the argmax", ties to the lowest index
(torch.argmax returns the first maximum). Padded points start at -inf and
can never be picked. d² is fp32 d_0² + d_1² + ... + d_{D-1}², each
difference, square and sum rounded in dimension order, the order the
kernel uses; over xyz alone it is ops/plain/fps.py's d².
"""

from __future__ import annotations

import torch

from tpu3dsad_torch.ops.args import check_ffps


def feature_fps(points: torch.Tensor, npoint: int,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """points [B, N, D] (+mask [B, N]) -> idx [B, npoint] int32."""
    check_ffps(points, npoint, mask)
    B, N, D = points.shape
    x = points.float()
    valid = (torch.ones(B, N, dtype=torch.bool, device=x.device)
             if mask is None else mask.bool())
    dist = torch.where(valid, torch.inf, -torch.inf)
    idx = torch.zeros(B, npoint, dtype=torch.int32, device=x.device)
    rows = torch.arange(B, device=x.device)
    last = torch.zeros(B, dtype=torch.long, device=x.device)
    for i in range(1, npoint):
        d = x - x[rows, last][:, None, :]
        sq = d * d
        d2 = sq[..., 0].clone()
        for k in range(1, D):
            d2 += sq[..., k]
        dist = torch.minimum(dist, torch.where(valid, d2, -torch.inf))
        last = dist.argmax(-1)
        idx[:, i] = last.int()
    return idx
