"""Shape and range checks of the FPS, feature FPS, ball-query, scatter,
NMS-walk, oriented-IoU, BatchNorm + ReLU and box point-count arguments.

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


def check_ffps(points: torch.Tensor, npoint: int,
               mask: torch.Tensor | None) -> None:
    if points.dim() != 3 or points.shape[-1] < 1:
        raise ValueError(f"points must be [B, N, D], got {tuple(points.shape)}")
    _mask(mask, points)
    if not 0 < npoint <= points.shape[1]:
        raise ValueError(
            f"npoint={npoint} out of range for N={points.shape[1]}")


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


def check_scatter(g: torch.Tensor, idx: torch.Tensor, n: int) -> None:
    if g.dim() != 3:
        raise ValueError(f"g must be [B, U, C], got {tuple(g.shape)}")
    if idx.shape != g.shape[:2]:
        raise ValueError(f"idx must be [B, U] = {tuple(g.shape[:2])}, "
                         f"got {tuple(idx.shape)}")
    if idx.is_floating_point():
        raise TypeError(f"idx must be an integer tensor, got {idx.dtype}")
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")


def check_nms(iou: torch.Tensor, scores: torch.Tensor,
              valid: torch.Tensor) -> None:
    if scores.dim() != 2:
        raise ValueError(f"scores must be [B, K], got {tuple(scores.shape)}")
    B, K = scores.shape
    if iou.shape != (B, K, K):
        raise ValueError(f"iou must be [B, K, K] = {(B, K, K)}, "
                         f"got {tuple(iou.shape)}")
    if valid.shape != scores.shape:
        raise ValueError(f"valid must be [B, K] = {(B, K)}, "
                         f"got {tuple(valid.shape)}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")


def check_iou(corners_a: torch.Tensor, corners_b: torch.Tensor) -> None:
    for name, c in (("corners_a", corners_a), ("corners_b", corners_b)):
        if c.dim() != 4 or tuple(c.shape[-2:]) != (8, 3):
            raise ValueError(f"{name} must be [B, K, 8, 3], "
                             f"got {tuple(c.shape)}")
        if not c.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {c.dtype}")
    if corners_a.shape[0] != corners_b.shape[0]:
        raise ValueError(f"corners_b batch {corners_b.shape[0]} != "
                         f"corners_a batch {corners_a.shape[0]}")


def check_bn_relu(x: torch.Tensor, *vectors: torch.Tensor) -> None:
    """x [..., C]; mean, var, weight and bias [C], all floating point."""
    if x.dim() < 1:
        raise ValueError("x must be [..., C], got a 0-d tensor")
    C = x.shape[-1]
    for name, v in zip(("mean", "var", "weight", "bias"), vectors):
        if tuple(v.shape) != (C,):
            raise ValueError(f"{name} must be [C] = ({C},), got "
                             f"{tuple(v.shape)}")
    for name, t in zip(("x", "mean", "var", "weight", "bias"),
                       (x, *vectors)):
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")


def check_box_points(points: torch.Tensor, centers: torch.Tensor,
                     sizes: torch.Tensor,
                     mask: torch.Tensor | None) -> None:
    """points [B, N, 3], centers and sizes [B, P, 3], mask [B, N]; all
    but the mask floating point."""
    _points(points, "points")
    _points(centers, "centers")
    _mask(mask, points)
    if sizes.shape != centers.shape:
        raise ValueError(f"sizes must be [B, P, 3] = {tuple(centers.shape)}, "
                         f"got {tuple(sizes.shape)}")
    if centers.shape[0] != points.shape[0]:
        raise ValueError(f"centers batch {centers.shape[0]} != points batch "
                         f"{points.shape[0]}")
    for name, t in (("points", points), ("centers", centers),
                    ("sizes", sizes)):
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
