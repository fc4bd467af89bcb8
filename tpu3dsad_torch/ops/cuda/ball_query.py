"""Wrapper of the exact ball-query kernel (csrc/ball_query.cu), which
replaces the Pallas TPU kernel tpu3dsad/ops/pallas/ball_query.py::_kernel.

`launches` counts kernel launches made by this wrapper, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import torch

from tpu3dsad_torch.ops.args import check_ball_query
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda.common import mask_arg, points_arg, ptr, stream
from tpu3dsad_torch.ops.plain.ball_query import radius_sq

launches = 0


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               nsample: int, mask: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """xyz [B,N,3], centers [B,M,3] fp32 CUDA -> (idx [B,M,K] int32,
    cnt [B,M] int32)."""
    global launches
    check_ball_query(xyz, centers, nsample, mask)
    xyz = points_arg(xyz, "xyz")
    centers = points_arg(centers, "centers")
    valid = mask_arg(mask, xyz)
    B, N, _ = xyz.shape
    M = centers.shape[1]
    if centers.device != xyz.device:
        raise ValueError(f"centers must be on {xyz.device}")
    lib = build.library()
    idx = torch.empty(B, M, nsample, dtype=torch.int32, device=xyz.device)
    cnt = torch.empty(B, M, dtype=torch.int32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        err = lib.tpu3dsad_ball_query(
            ptr(xyz), ptr(valid), ptr(centers), ptr(idx), ptr(cnt),
            B, N, M, nsample, radius_sq(radius), stream(xyz))
    build.check(err, "tpu3dsad_ball_query")
    launches += 1
    return idx, cnt
