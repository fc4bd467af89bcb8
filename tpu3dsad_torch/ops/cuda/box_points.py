"""Wrapper of the box point-count kernel (csrc/box_points.cu), which
replaces the plain version's [B, P, N] comparisons (ops/plain/box_points.py)
with one launch that streams each scene's points through shared memory
and writes each box's count once, with the plain version's counts.

`launches` counts the kernel's launches by this wrapper, one a Group-Free
parse, and `work` the point-box tests they made (B P N a launch), so a run
can show that its filter went through the kernel and at what size.
"""

from __future__ import annotations

import contextlib

import torch

from tpu3dsad_torch.ops.args import check_box_points
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda.common import mask_arg, points_arg, ptr, stream

launches = 0
work = 0


def box_points(points: torch.Tensor, centers: torch.Tensor,
               sizes: torch.Tensor,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """points [B,N,3], centers and sizes [B,P,3] fp32 CUDA, mask [B,N] ->
    counts [B,P] int32, equal to the plain version's."""
    global launches, work
    check_box_points(points, centers, sizes, mask)
    points = points_arg(points, "points")
    dev = points.device
    for name, t in (("centers", centers), ("sizes", sizes)):
        if t.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {t.device}")
    centers = points_arg(centers, "centers")
    sizes = points_arg(sizes, "sizes")
    mask = mask_arg(mask, points)
    B, N, _ = points.shape
    P = centers.shape[1]
    # the kernel writes every count (0 where a scene has no point)
    counts = torch.empty(B, P, dtype=torch.int32, device=dev)
    if B == 0 or P == 0:
        return counts
    lib = build.library()
    here = (contextlib.nullcontext()
            if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))
    with here:
        err = lib.tpu3dsad_box_points(ptr(points), ptr(mask), ptr(centers),
                                      ptr(sizes), ptr(counts), B, N, P,
                                      stream(points))
    build.check(err, "tpu3dsad_box_points")
    launches += 1
    work += B * P * N
    return counts
