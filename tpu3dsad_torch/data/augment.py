"""Point-cloud and box augmentation on the host, in numpy
(tpu3dsad/data/augment.py): random flips along x / y, a rotation about the
up axis and a global scale. Boxes transform with the cloud; the caller
recomputes the vote targets afterwards. For one generator state it draws
and computes exactly what the reference does.

`resolve_aug` gives the recipe both this host path and the on-card path
(device_pipeline.augment_batch) apply.
"""

from __future__ import annotations

import numpy as np


def rot_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


# lineage augmentation recipes per dataset; rot_range is a HALF-range,
# angle ~ U(-r, +r):
#   scannet: both flips, +-5 deg, no scale
#   sunrgbd: the x flip only, +-30 deg, scale 0.85-1.15
#   kitti:   the y flip, +-45 deg, scale 0.95-1.05 (no lineage recipe)
AUG_PRESETS = {
    "scannet": dict(flip_x=True, flip_y=True, rot_range=np.pi / 36,
                    scale_range=None),
    "sunrgbd": dict(flip_x=True, flip_y=False, rot_range=np.pi / 6,
                    scale_range=(0.85, 1.15)),
    "kitti": dict(flip_x=False, flip_y=True, rot_range=np.pi / 4,
                  scale_range=(0.95, 1.05)),
}


def resolve_aug(data_cfg, dataset_name: str) -> dict:
    """Effective augmentation parameters: 'auto' takes the dataset's
    recipe, a preset name forces that recipe, 'custom' the aug_* fields.
    Anything else raises: the aug_* fields do nothing outside 'custom', so
    a typo must not pass."""
    preset = data_cfg.aug_preset
    if preset == "custom":
        scale = (None
                 if data_cfg.aug_scale_min == data_cfg.aug_scale_max == 1.0
                 else (data_cfg.aug_scale_min, data_cfg.aug_scale_max))
        return dict(flip_x=data_cfg.aug_flip_x, flip_y=data_cfg.aug_flip_y,
                    rot_range=data_cfg.aug_rot_range, scale_range=scale)
    if preset == "auto":
        return AUG_PRESETS.get(dataset_name, AUG_PRESETS["scannet"])
    if preset in AUG_PRESETS:
        return AUG_PRESETS[preset]
    raise ValueError(
        f"data.aug_preset={preset!r}: expected 'auto', 'custom', or one of "
        f"{sorted(AUG_PRESETS)}")


def augment_scene(rng: np.random.Generator, points: np.ndarray,
                  centers: np.ndarray, headings: np.ndarray,
                  sizes: np.ndarray, flip_x: bool = True, flip_y: bool = True,
                  rot_range: float = np.pi / 36,
                  scale_range: tuple[float, float] | None = None):
    """(points, centers, headings, sizes) flipped, rotated and scaled by
    draws from `rng`; points [N,3+F], of which only xyz transform."""
    xyz = points[:, :3].copy()
    centers = centers.copy()
    headings = headings.copy()
    sizes = sizes.copy()

    if flip_x and rng.random() < 0.5:  # the YZ plane
        xyz[:, 0] = -xyz[:, 0]
        centers[:, 0] = -centers[:, 0]
        headings = np.pi - headings
    if flip_y and rng.random() < 0.5:  # the XZ plane
        xyz[:, 1] = -xyz[:, 1]
        centers[:, 1] = -centers[:, 1]
        headings = -headings

    angle = rng.uniform(-rot_range, rot_range)
    r = rot_z(angle)
    xyz = xyz @ r.T
    centers = centers @ r.T
    headings = headings + angle

    if scale_range is not None:
        s = rng.uniform(*scale_range)
        xyz *= s
        centers *= s
        sizes *= s

    headings = np.mod(headings + np.pi, 2 * np.pi) - np.pi
    out = points.copy()
    out[:, :3] = xyz
    return out, centers, headings, sizes
