"""Synthetic outdoor (KITTI-style) scene writer, benchmark config #4
(tpu3dsad/data/synthetic_outdoor.py, pure numpy; for one seed it writes
byte-identical files).

No real KITTI files are in the repository, so config #4 runs on fabricated
scenes with the statistics that make outdoor detection hard: ~100k-point
clouds over a 70 m x 80 m range, LiDAR-like 1/r density falloff, sparse
small objects (tens to hundreds of points per car), non-overlapping boxes
(the KITTI annotation convention), ground plus building and pole clutter.

Scenes are written in the on-disk contract of data/kitti.py
(`<idx>_pc.npy` [N,4] xyz+intensity, `<idx>_bbox.npy` [G,8]).

CLI:
    python -m tpu3dsad_torch.data.synthetic_outdoor out=/path [scenes=48]
        [val_scenes=12] [points=98304] [seed=0]
"""

from __future__ import annotations

import os

import numpy as np

from tpu3dsad_torch.data.kitti import KITTI_MEAN_SIZES, RANGE_MAX, RANGE_MIN

# sensor at the origin; front FOV matching the crop box of data/kitti.py
_FOV = np.arctan2(40.0, 10.0)  # half-angle covering the y extent early


def _range_density_ranges(rng, n, r_min=2.0, r_max=72.0):
    """Sample ranges with p(r) ~ 1/r (LiDAR ring density falloff)."""
    u = rng.random(n)
    return r_min * (r_max / r_min) ** u


def _ground(rng, n):
    r = _range_density_ranges(rng, n)
    theta = rng.uniform(-_FOV, _FOV, n)
    x = r * np.cos(theta)
    y = r * np.sin(theta)
    # gentle road crown + noise
    z = -1.73 + 0.002 * np.abs(y) + 0.03 * rng.standard_normal(n)
    return np.stack([x, y, z], -1)


def _clutter(rng, n):
    """Vertical structure: building facades near the lateral edges + poles."""
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


def outdoor_scene(rng: np.random.Generator, num_points: int = 98304,
                  max_objects: int = 12, min_objects: int = 3):
    """One KITTI-style scene.

    Returns (pc [N,4] float32 xyz+intensity, boxes [G,8] float32
    cx cy cz dx dy dz heading cls). Class mix ~ KITTI: cars dominate.
    Boxes never overlap (rejection placement) and sit on the local ground.
    """
    g_target = int(rng.integers(min_objects, max_objects + 1))
    classes, centers, sizes, headings = [], [], [], []
    tries = 0
    while len(classes) < g_target and tries < 200:
        tries += 1
        cls = int(rng.choice([0, 0, 0, 1, 2]))  # 3:1:1 car:ped:cyc
        size = KITTI_MEAN_SIZES[cls] * rng.uniform(0.85, 1.15, 3)
        x = rng.uniform(6.0, 60.0)
        y = rng.uniform(-0.55 * x, 0.55 * x)  # inside the FOV wedge
        if not (RANGE_MIN[1] + 2 < y < RANGE_MAX[1] - 2):
            continue
        # rejection: keep centers farther apart than the summed radii
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
    cls_arr = np.asarray(classes, np.float64).reshape(g)

    # point budget: objects get range-dependent counts (real LiDAR: a car at
    # 10 m is ~1-2k points at 64 beams, ~100 at 50 m)
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
    xyz += 0.015 * rng.standard_normal(xyz.shape)  # sensor noise
    intensity = rng.random(len(xyz))[:, None]
    pc = np.concatenate([xyz, intensity], -1).astype(np.float32)
    pc = pc[rng.permutation(len(pc))]

    boxes = np.concatenate(
        [centers, sizes, headings[:, None], cls_arr[:, None]], -1
    ).astype(np.float32)
    return pc, boxes


def write_dataset(root: str, scenes: int = 48, val_scenes: int = 12,
                  num_points: int = 98304, seed: int = 0):
    rng = np.random.default_rng(seed)
    for split, count, base in (("train", scenes, 0),
                               ("val", val_scenes, scenes)):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for i in range(count):
            pc, boxes = outdoor_scene(rng, num_points)
            np.save(os.path.join(d, f"{base + i:06d}_pc.npy"), pc)
            np.save(os.path.join(d, f"{base + i:06d}_bbox.npy"), boxes)
    return root


def main(argv):
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    if "out" not in kv:
        raise SystemExit(__doc__)
    write_dataset(
        kv["out"],
        scenes=int(kv.get("scenes", 48)),
        val_scenes=int(kv.get("val_scenes", 12)),
        num_points=int(kv.get("points", 98304)),
        seed=int(kv.get("seed", 0)),
    )
    print(f"wrote {kv['out']}")


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
