"""Raw outdoor LiDAR scans for the KITTI cell: a frozen copy of
tpu3dsad_torch/data/synthetic_outdoor.py::outdoor_scene (numpy, seeded),
kept here so that no later change to the program moves the yardstick.

A KITTI-style scan at the HDL-64E's size: ground with a 1/r range falloff
over a front wedge, building facades and poles, 3-12 non-overlapping cars,
pedestrians and cyclists on the ground with range-dependent point counts,
1.5 cm of noise, and an intensity column, in a random point order. The
scan covers a front wedge of +-76 degrees, not a real sweep's 360, so the
front-camera crop (reference/outdoor.py) keeps about 96% of it, where it
keeps about half of a real sweep.
"""

from __future__ import annotations

import numpy as np

# KITTI's three classes (car, pedestrian, cyclist) and their mean box sizes
# (meters): data/kitti.py's KITTI_MEAN_SIZES
KITTI_MEAN_SIZES = np.array(
    [[3.88, 1.63, 1.53], [0.84, 0.66, 1.74], [1.76, 0.60, 1.73]], np.float32
)
# the y extent of the front-camera crop box the objects stay inside
_Y_MIN, _Y_MAX = -40.0, 40.0
_FOV = np.arctan2(40.0, 10.0)  # half-angle of the scanned wedge


def _range_density_ranges(rng, n, r_min=2.0, r_max=72.0):
    u = rng.random(n)
    return r_min * (r_max / r_min) ** u


def _ground(rng, n):
    r = _range_density_ranges(rng, n)
    theta = rng.uniform(-_FOV, _FOV, n)
    x = r * np.cos(theta)
    y = r * np.sin(theta)
    z = -1.73 + 0.002 * np.abs(y) + 0.03 * rng.standard_normal(n)
    return np.stack([x, y, z], -1)


def _clutter(rng, n):
    n_wall = n // 2
    side = rng.choice([-1.0, 1.0], n_wall)
    x = rng.uniform(5.0, 68.0, n_wall)
    y = side * rng.uniform(12.0, 38.0, n_wall)
    z = rng.uniform(-1.7, 0.9, n_wall)
    walls = np.stack([x, y, z], -1)

    n_pole = n - n_wall
    k = max(1, n_pole // 40)
    px = rng.uniform(5.0, 65.0, k)
    py = rng.uniform(-30.0, 30.0, k)
    pick = rng.integers(0, k, n_pole)
    z = rng.uniform(-1.7, 0.9, n_pole)
    poles = np.stack(
        [px[pick] + 0.05 * rng.standard_normal(n_pole),
         py[pick] + 0.05 * rng.standard_normal(n_pole), z], -1
    )
    return np.concatenate([walls, poles])


def _box_surface(rng, n, size):
    pts = rng.uniform(-0.5, 0.5, (n, 3))
    ax = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    pts[np.arange(n), ax] = 0.5 * sign
    return (pts * size).astype(np.float64)


def outdoor_scene(rng: np.random.Generator, num_points: int = 122880,
                  max_objects: int = 12, min_objects: int = 3) -> np.ndarray:
    """One raw scan [num_points, 4] float32, xyz + intensity (the original
    also returns the boxes, which no cell reads; the draws are the
    same)."""
    g_target = int(rng.integers(min_objects, max_objects + 1))
    classes, centers, sizes, headings = [], [], [], []
    tries = 0
    while len(classes) < g_target and tries < 200:
        tries += 1
        cls = int(rng.choice([0, 0, 0, 1, 2]))
        size = KITTI_MEAN_SIZES[cls] * rng.uniform(0.85, 1.15, 3)
        x = rng.uniform(6.0, 60.0)
        y = rng.uniform(-0.55 * x, 0.55 * x)
        if not (_Y_MIN + 2 < y < _Y_MAX - 2):
            continue
        ok = True
        for c0, s0 in zip(centers, sizes):
            min_d = 0.6 * (np.hypot(*size[:2]) + np.hypot(*s0[:2])) + 0.5
            if np.hypot(x - c0[0], y - c0[1]) < min_d:
                ok = False
                break
        if not ok:
            continue
        z = -1.73 + 0.002 * abs(y) + size[2] / 2
        classes.append(cls)
        centers.append([x, y, z])
        sizes.append(size)
        headings.append(rng.uniform(-np.pi, np.pi))
    g = len(classes)
    centers = np.asarray(centers, np.float64).reshape(g, 3)
    sizes = np.asarray(sizes, np.float64).reshape(g, 3)
    headings = np.asarray(headings, np.float64).reshape(g)

    obj_counts = np.zeros(g, int)
    for i in range(g):
        r = float(np.hypot(centers[i, 0], centers[i, 1]))
        area = float(sizes[i, 0] * sizes[i, 2] + sizes[i, 1] * sizes[i, 2])
        obj_counts[i] = int(np.clip(9000.0 * area / r, 40, 2500))
    n_obj = int(obj_counts.sum())
    n_clutter = int(0.18 * (num_points - n_obj))
    n_ground = num_points - n_obj - n_clutter

    parts = [_ground(rng, n_ground), _clutter(rng, n_clutter)]
    for i in range(g):
        local = _box_surface(rng, obj_counts[i], sizes[i])
        c, s = np.cos(headings[i]), np.sin(headings[i])
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        parts.append(local @ rot.T + centers[i])
    xyz = np.concatenate(parts)
    xyz += 0.015 * rng.standard_normal(xyz.shape)
    intensity = rng.random(len(xyz))[:, None]
    pc = np.concatenate([xyz, intensity], -1).astype(np.float32)
    return pc[rng.permutation(len(pc))]


def scan_pool(rng: np.random.Generator, w: dict):
    """The KITTI cell's pool: (raw scans [P, B, raw_points, 4] float32, the
    pool batches that `correct` checks), P = pool_batches, B = batch."""
    P, B = w["pool_batches"], w["batch"]
    scans = np.stack([outdoor_scene(rng, w["raw_points"])
                      for _ in range(P * B)])
    checked = set(rng.choice(P, w["check_batches"], replace=False).tolist())
    return scans.reshape(P, B, w["raw_points"], 4), checked
