"""The points inside each axis-aligned box, as plain PyTorch: the
comparisons of mmcv's points_in_boxes at the heading 0 (strict faces in x
and y, an inclusive face in z), held to the kernel (csrc/box_points.cu)
bit for bit."""

from __future__ import annotations

import torch

from tpu3dsad_torch.ops.args import check_box_points

SLAB = 1 << 26  # point-box tests a block of boxes holds at once


def box_points(points: torch.Tensor, centers: torch.Tensor,
               sizes: torch.Tensor,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """points [B,N,3], centers and sizes [B,P,3], mask [B,N] -> counts
    [B,P] int32: the valid points q of each scene with |q.x - c.x| <
    s.x * 0.5, |q.y - c.y| < s.y * 0.5 and |q.z - c.z| <= s.z * 0.5, each
    difference rounded in the inputs' precision. Computed a block of boxes
    at a time, SLAB tests each."""
    check_box_points(points, centers, sizes, mask)
    B, N, _ = points.shape
    P = centers.shape[1]
    valid = (torch.ones(B, N, dtype=torch.bool, device=points.device)
             if mask is None else mask.bool())
    half = sizes * 0.5
    out = torch.zeros(B, P, dtype=torch.int32, device=points.device)
    step = max(1, SLAB // max(B * N, 1))
    for s in range(0, P, step):
        gap = (points[:, None] - centers[:, s:s + step, None]).abs()
        h = half[:, s:s + step, None]
        inside = ((gap[..., 0] < h[..., 0]) & (gap[..., 1] < h[..., 1])
                  & (gap[..., 2] <= h[..., 2]) & valid[:, None])
        out[:, s:s + step] = inside.sum(-1, dtype=torch.int32)
    return out
