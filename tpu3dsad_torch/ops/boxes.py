"""3D box geometry for the heading bins, the axis-aligned NMS and the
oriented BEV IoU of oriented NMS (tpu3dsad/ops/boxes.py:35-184); the
oriented IoU itself is the custom op tpu3dsad_torch::oriented_bev_iou
(ops/library.py).

Convention: Z-up, heading is a counter-clockwise rotation about +Z, size is
(l, w, h) full extents.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu3dsad_torch.ops import library as _library
from tpu3dsad_torch.utils.constants import device_constant

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
    signs = device_constant(_CORNER_SIGNS, size.device)
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


def center_size_to_aabb(center, size):
    """Axis-aligned box directly from center/size (heading ignored)."""
    half = 0.5 * size
    return center - half, center + half




def oriented_bev_iou(corners_a: torch.Tensor, corners_b: torch.Tensor):
    """Pairwise IoU of oriented 3D boxes from [...,K,8,3] / [...,L,8,3]
    corners (box_corners convention: top face 0-3 CCW, Z-up) -> [...,K,L]:
    the BEV polygon clip times the z-extent overlap, the geometry of
    eval/ap.py::box3d_iou_oriented. The leading dims are broadcast and
    flattened into the batch of the op tpu3dsad_torch::oriented_bev_iou:
    csrc/iou.cu on a CUDA tensor, the plain chain of ops/plain/iou.py on
    the CPU or inside ops.use_impl("plain")."""
    lead = torch.broadcast_shapes(corners_a.shape[:-3], corners_b.shape[:-3])
    K, L = corners_a.shape[-3], corners_b.shape[-3]
    a = corners_a.expand(*lead, K, 8, 3).reshape(math.prod(lead), K, 8, 3)
    b = corners_b.expand(*lead, L, 8, 3).reshape(math.prod(lead), L, 8, 3)
    return _library.oriented_bev_iou(a, b).reshape(*lead, K, L)
