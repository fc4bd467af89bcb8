"""Indoor rooms for the serving cells: a frozen copy of
tpu3dsad_torch/data/synthetic_indoor.py::indoor_scene (numpy, seeded), kept
here so that no later change to the program moves the yardstick.

A room of 4-7 m with 3-8 axis-aligned objects sitting on the floor: ~22%
of the points on the floor, ~8% on the walls, the rest on the objects'
surfaces, 5 mm of noise, in a random point order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ScanNet's 18 detection classes as nyu40 ids, and their mean box sizes
# (meters): data/scannet.py's NYU40_IDS and SCANNET_MEAN_SIZES
NYU40_IDS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)
SCANNET_MEAN_SIZES = np.array(
    [
        [0.775, 0.949, 0.966], [1.876, 1.842, 1.193], [0.612, 0.620, 0.704],
        [1.442, 1.605, 0.837], [1.160, 1.055, 0.500], [0.620, 0.726, 2.023],
        [0.288, 1.160, 1.384], [0.404, 1.074, 1.688], [0.596, 0.551, 0.850],
        [0.388, 0.600, 0.728], [0.696, 1.347, 0.500], [0.555, 1.006, 1.883],
        [0.972, 1.557, 0.948], [0.582, 1.163, 1.815], [0.406, 0.506, 0.504],
        [0.489, 0.632, 0.602], [0.868, 1.270, 1.334], [0.261, 0.283, 0.543],
    ],
    np.float32,
)


def indoor_scene(rng: np.random.Generator, num_points: int = 20000,
                 max_objects: int = 8, min_objects: int = 3) -> np.ndarray:
    """One room's xyz [num_points, 3] float32 (the original also returns
    colors and labels, which no cell reads; the draws are the same)."""
    room = float(rng.uniform(4.0, 7.0))
    g = int(rng.integers(min_objects, max_objects + 1))
    classes = rng.integers(0, len(NYU40_IDS), g)
    sizes = SCANNET_MEAN_SIZES[classes] * rng.uniform(0.8, 1.25, (g, 3))
    centers = np.stack(
        [
            rng.uniform(-room / 2 + 1, room / 2 - 1, g),
            rng.uniform(-room / 2 + 1, room / 2 - 1, g),
            sizes[:, 2] / 2,
        ],
        -1,
    ).astype(np.float32)

    n_floor = int(0.22 * num_points)
    n_wall = int(0.08 * num_points)
    n_obj_total = num_points - n_floor - n_wall
    per = np.full(g, n_obj_total // g)
    per[: n_obj_total - per.sum()] += 1

    pts = [np.stack(
        [
            rng.uniform(-room / 2, room / 2, n_floor),
            rng.uniform(-room / 2, room / 2, n_floor),
            0.01 * rng.standard_normal(n_floor),
        ],
        -1,
    )]
    side = rng.integers(0, 4, n_wall)
    along = rng.uniform(-room / 2, room / 2, n_wall)
    wx = np.where(side < 2, along, np.where(side == 2, -room / 2, room / 2))
    wy = np.where(side < 2, np.where(side == 0, -room / 2, room / 2), along)
    walls = np.stack([wx, wy, rng.uniform(0.0, 2.4, n_wall)], -1)
    walls += 0.01 * rng.standard_normal(walls.shape)
    pts.append(walls)
    for i in range(g):
        n = int(per[i])
        cube = rng.uniform(-0.5, 0.5, (n, 3))
        ax = rng.integers(0, 3, n)
        cube[np.arange(n), ax] = 0.5 * rng.choice([-1.0, 1.0], n)
        pts.append(cube * sizes[i] + centers[i])

    xyz = np.concatenate(pts).astype(np.float32)
    xyz += 0.005 * rng.standard_normal(xyz.shape).astype(np.float32)
    rng.integers(30, 226, (g + 1, 3))  # the original's palette draw
    return xyz[rng.permutation(num_points)]


def padded(xyz: np.ndarray, budget: int) -> tuple[np.ndarray, np.ndarray]:
    """[n, 3] -> ([budget, 3] with zero rows after n, mask [budget])."""
    n = len(xyz)
    out = np.zeros((budget, 3), np.float32)
    out[:n] = xyz
    mask = np.zeros(budget, bool)
    mask[:n] = True
    return out, mask


def sweep_pool(rng: np.random.Generator, w: dict):
    """A sweep cell's pool: (points [P, B, budget, 3], masks [P, B, budget],
    the pool batches that `correct` checks), P = pool_batches,
    B = batch."""
    P, B = w["pool_batches"], w["batch"]
    scenes = [padded(indoor_scene(rng, w["points"]), w["budget"])
              for _ in range(P * B)]
    pts = np.stack([s[0] for s in scenes]).reshape(P, B, w["budget"], 3)
    masks = np.stack([s[1] for s in scenes]).reshape(P, B, w["budget"])
    checked = set(rng.choice(P, w["check_batches"], replace=False).tolist())
    return pts, masks, checked


def scan_pool(rng: np.random.Generator, w: dict):
    """A latency cell's pool: (raw scans, the order they are served in)."""
    raws = [indoor_scene(rng, w["raw_points"])
            for _ in range(w["pool_scenes"])]
    order = rng.permutation(w["pool_scenes"])
    return raws, order


def frames(seconds: float, rate_hz: float) -> int:
    """The frames due in `seconds` at `rate_hz`, the first at 0."""
    return max(1, math.ceil(seconds * rate_hz - 1e-9))


def pick_checked(seed: int, due: int, n: int) -> set:
    """The requests (by their place among the `due` requests of a window)
    that `correct` checks: `n` drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    return set(rng.choice(due, min(n, due), replace=False).tolist())


def fit(raw: np.ndarray, budget: int):
    """The benchmark's own fit of a raw scan to one [1, budget] cloud, as
    the serving CLI fits it: a subsample without replacement drawn from a
    generator of seed 0 where the scan is larger, else zero rows after it
    under a False mask."""
    pts = raw[:, :3].astype(np.float32)
    sel = (np.random.default_rng(0).choice(len(pts), budget, replace=False)
           if len(pts) > budget else np.arange(len(pts)))
    out = np.zeros((1, budget, 3), np.float32)
    out[0, :len(sel)] = pts[sel]
    mask = np.zeros((1, budget), bool)
    mask[0, :len(sel)] = True
    return torch.from_numpy(out), torch.from_numpy(mask)


def fit_batch(raws: list, budget: int):
    """fit of each scan, stacked: ([n, budget, 3], [n, budget])."""
    fitted = [fit(r, budget) for r in raws]
    return (torch.cat([f[0] for f in fitted]),
            torch.cat([f[1] for f in fitted]))
