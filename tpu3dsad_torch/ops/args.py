"""Shape and range checks of the FPS and ball-query arguments.

Both implementations, the plain versions and the kernel wrappers, call
these once on entry, so each path checks its arguments exactly once.
"""

from __future__ import annotations

import torch


def _points(t: torch.Tensor, name: str) -> None:
    if t.dim() != 3 or t.shape[-1] != 3:
        raise ValueError(f"{name} must be [B, N, 3], got {tuple(t.shape)}")


def _mask(mask: torch.Tensor | None, xyz: torch.Tensor) -> None:
    if mask is not None and mask.shape != xyz.shape[:2]:
        raise ValueError(f"mask must be [B, N] = {tuple(xyz.shape[:2])}, "
                         f"got {tuple(mask.shape)}")


def check_fps(xyz: torch.Tensor, npoint: int,
              mask: torch.Tensor | None) -> None:
    _points(xyz, "xyz")
    _mask(mask, xyz)
    if not 0 < npoint <= xyz.shape[1]:
        raise ValueError(f"npoint={npoint} out of range for N={xyz.shape[1]}")


def check_ball_query(xyz: torch.Tensor, centers: torch.Tensor, nsample: int,
                     mask: torch.Tensor | None) -> None:
    _points(xyz, "xyz")
    _points(centers, "centers")
    _mask(mask, xyz)
    if centers.shape[0] != xyz.shape[0]:
        raise ValueError(f"centers batch {centers.shape[0]} != xyz batch "
                         f"{xyz.shape[0]}")
    if nsample <= 0:
        raise ValueError(f"nsample must be positive, got {nsample}")
