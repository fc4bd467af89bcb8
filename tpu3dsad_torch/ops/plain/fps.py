"""Furthest point sampling — plain PyTorch version of csrc/fps.cu.

Counterpart of tpu3dsad/ops/xla/fps.py: start at index 0, then npoint-1
rounds of "update the running min squared distance to the chosen set, pick
the argmax", ties to the lowest index (torch.argmax returns the first
maximum). Padded points start at -inf and can never be picked. d² is
elementwise (dx*dx + dy*dy) + dz*dz in fp32, the order the kernel uses.
"""

from __future__ import annotations

import torch

from tpu3dsad_torch.ops.args import check_fps


def furthest_point_sample(xyz: torch.Tensor, npoint: int,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """xyz [B, N, 3] (+mask [B, N]) -> idx [B, npoint] int32."""
    check_fps(xyz, npoint, mask)
    B, N, _ = xyz.shape
    xyz = xyz.float()
    valid = (torch.ones(B, N, dtype=torch.bool, device=xyz.device)
             if mask is None else mask.bool())
    dist = torch.where(valid, torch.inf, -torch.inf)
    idx = torch.zeros(B, npoint, dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        d = xyz - xyz[rows, last][:, None, :]
        dx, dy, dz = d.unbind(-1)
        d2 = dx * dx + dy * dy + dz * dz
        dist = torch.minimum(dist, torch.where(valid, d2, -torch.inf))
        last = dist.argmax(-1)
        idx[:, i] = last.int()
    return idx
