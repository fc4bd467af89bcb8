"""Wrapper of the FPS kernel (csrc/fps.cu), which replaces the Pallas TPU
kernel tpu3dsad/ops/pallas/fps.py::_fps_kernel.

`launches` counts kernel launches made by this wrapper, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import torch

from tpu3dsad_torch.ops.args import check_fps
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda.common import mask_arg, points_arg, ptr, stream

launches = 0


def furthest_point_sample(xyz: torch.Tensor, npoint: int,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """xyz [B, N, 3] fp32 CUDA (+mask [B, N]) -> idx [B, npoint] int32."""
    global launches
    check_fps(xyz, npoint, mask)
    xyz = points_arg(xyz, "xyz")
    valid = mask_arg(mask, xyz)
    B, N, _ = xyz.shape
    lib = build.library()
    idx = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    dist = torch.empty(B, N, dtype=torch.float32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        err = lib.tpu3dsad_fps(ptr(xyz), ptr(valid), ptr(dist), ptr(idx),
                               B, N, npoint, stream(xyz))
    build.check(err, "tpu3dsad_fps")
    launches += 1
    return idx
