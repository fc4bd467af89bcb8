"""3D box geometry for the heading bins and axis-aligned NMS
(tpu3dsad/ops/boxes.py:35-91).

Convention: Z-up, heading is a counter-clockwise rotation about +Z, size is
(l, w, h) full extents. The oriented BEV IoU of the reference waits for
nms_oriented (ROADMAP A5b).
"""

from __future__ import annotations

import numpy as np
import torch

# unit-cube corner signs: top face counter-clockwise, then the bottom face
_CORNER_SIGNS = np.array(
    [
        [+0.5, +0.5, +0.5],
        [-0.5, +0.5, +0.5],
        [-0.5, -0.5, +0.5],
        [+0.5, -0.5, +0.5],
        [+0.5, +0.5, -0.5],
        [-0.5, +0.5, -0.5],
        [-0.5, -0.5, -0.5],
        [+0.5, -0.5, -0.5],
    ],
    dtype=np.float32,
)


def angle_from_bin(bin_cls: torch.Tensor, residual: torch.Tensor,
                   num_bins: int) -> torch.Tensor:
    """(bin index, residual) -> heading angle, wrapped to [-π, π)."""
    angle = bin_cls.float() * (2.0 * np.pi / num_bins) + residual
    return torch.where(angle > np.pi, angle - 2.0 * np.pi, angle)


def mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """x mod y with the sign of y, as jnp.mod computes it: the exact fmod,
    plus y where the signs differ (torch.remainder rounds x - floor(x/y)*y
    instead, an ulp of y away near multiples of y)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def angle_to_bin(angle: torch.Tensor, num_bins: int):
    """heading angle -> (bin index int32, residual). Inverse of
    angle_from_bin (tpu3dsad/ops/boxes.py:46-54)."""
    two_pi = 2.0 * np.pi
    angle = mod(angle, two_pi)
    bin_width = two_pi / num_bins
    shifted = mod(angle + bin_width / 2.0, two_pi)
    bin_cls = torch.floor(shifted / bin_width).int()
    residual = shifted - (bin_cls.float() * bin_width + bin_width / 2.0)
    return bin_cls, residual


def box_corners(center: torch.Tensor, size: torch.Tensor,
                heading: torch.Tensor) -> torch.Tensor:
    """center [...,3], size [...,3], heading [...] -> corners [...,8,3]."""
    signs = torch.as_tensor(_CORNER_SIGNS, device=size.device)
    ext = size[..., None, :] * signs  # [..., 8, 3]
    c, s = torch.cos(heading)[..., None], torch.sin(heading)[..., None]
    x = ext[..., 0] * c - ext[..., 1] * s
    y = ext[..., 0] * s + ext[..., 1] * c
    rot = torch.stack([x, y, ext[..., 2]], -1)
    return rot + center[..., None, :]


def corners_to_aabb(corners: torch.Tensor):
    """corners [...,8,3] -> (mins [...,3], maxs [...,3]) axis-aligned hull."""
    return corners.amin(-2), corners.amax(-2)


def aabb_iou_3d(min_a, max_a, min_b, max_b) -> torch.Tensor:
    """Pairwise IoU of axis-aligned boxes [..., K, 3] x [..., L, 3] ->
    [..., K, L]; zero-volume boxes get IoU 0."""
    lo = torch.maximum(min_a[..., :, None, :], min_b[..., None, :, :])
    hi = torch.minimum(max_a[..., :, None, :], max_b[..., None, :, :])
    inter = (hi - lo).clamp_min(0.0).prod(-1)
    vol_a = (max_a - min_a).clamp_min(0.0).prod(-1)
    vol_b = (max_b - min_b).clamp_min(0.0).prod(-1)
    union = vol_a[..., :, None] + vol_b[..., None, :] - inter
    return torch.where(union > 0.0, inter / union.clamp_min(1e-12), 0.0)
