"""Synthetic oriented scenes written in the SUN RGB-D on-disk contract
(tpu3dsad/data/synthetic_sunrgbd.py, pure numpy; for one seed it writes
byte-identical files).

No SUN RGB-D release is in the repository, so the oriented input path
(data/sunrgbd.py with heading boxes and [N,10] votes, then
data/packed.py) runs on fabricated scenes in the exact contract the
loader documents:

  <idx>_pc.npy     float32 [N, 6]   xyz + rgb(0-1), Z-up
  <idx>_bbox.npy   float32 [G, 8]   cx cy cz dx dy dz heading cls (0..9)
  <idx>_votes.npy  float32 [N, 10]  the lineage's 3-candidate layout
                                    (sunrgbd.lineage_votes, oriented
                                    containment)

The oriented complement of synthetic_indoor.py: boxes take a uniform
heading about +Z, sizes come from SUNRGBD_MEAN_SIZES, the surface points
are rotated by the heading, and floor and wall points carry no box.

CLI:
    python -m tpu3dsad_torch.data.synthetic_sunrgbd out=/path [scenes=256]
        [val_scenes=64] [points=20000] [seed=0]
"""

from __future__ import annotations

import os

import numpy as np

from tpu3dsad_torch.data.sunrgbd import SUNRGBD_MEAN_SIZES, lineage_votes


def oriented_scene(rng: np.random.Generator, num_points: int = 20000,
                   max_objects: int = 8, min_objects: int = 3):
    """One SUN RGB-D-style scene.

    Returns (pc [N,6] float32 rgb 0-1, bbox [G,8] float32,
    votes [N,10] float32). Object points are drawn on the rotated box
    surfaces so centers/headings are analytic.
    """
    room = float(rng.uniform(4.0, 7.0))
    g = int(rng.integers(min_objects, max_objects + 1))
    nc = len(SUNRGBD_MEAN_SIZES)
    classes = rng.integers(0, nc, g)
    sizes = SUNRGBD_MEAN_SIZES[classes] * rng.uniform(0.8, 1.25, (g, 3))
    headings = rng.uniform(-np.pi, np.pi, g)
    centers = np.stack(
        [
            rng.uniform(-room / 2 + 1, room / 2 - 1, g),
            rng.uniform(-room / 2 + 1, room / 2 - 1, g),
            sizes[:, 2] / 2,
        ],
        -1,
    )

    n_floor = int(0.22 * num_points)
    n_wall = int(0.08 * num_points)
    n_obj_total = num_points - n_floor - n_wall
    per = np.full(g, n_obj_total // g)
    per[: n_obj_total - per.sum()] += 1

    pts, colors = [], []
    floor = np.stack(
        [
            rng.uniform(-room / 2, room / 2, n_floor),
            rng.uniform(-room / 2, room / 2, n_floor),
            0.01 * rng.standard_normal(n_floor),
        ],
        -1,
    )
    pts.append(floor)
    colors.append(np.full((n_floor, 3), 0.5, np.float32))

    side = rng.integers(0, 4, n_wall)
    along = rng.uniform(-room / 2, room / 2, n_wall)
    wx = np.where(side < 2, along, np.where(side == 2, -room / 2, room / 2))
    wy = np.where(side < 2, np.where(side == 0, -room / 2, room / 2), along)
    walls = np.stack([wx, wy, rng.uniform(0.0, 2.4, n_wall)], -1)
    walls += 0.01 * rng.standard_normal(walls.shape)
    pts.append(walls)
    colors.append(np.full((n_wall, 3), 0.5, np.float32))

    for i in range(g):
        n = int(per[i])
        cube = rng.uniform(-0.5, 0.5, (n, 3))
        ax = rng.integers(0, 3, n)
        cube[np.arange(n), ax] = 0.5 * rng.choice([-1.0, 1.0], n)
        local = cube * sizes[i]
        c, s = np.cos(headings[i]), np.sin(headings[i])
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        pts.append(local @ rot.T + centers[i])
        colors.append(
            np.tile(rng.uniform(0.1, 0.9, 3).astype(np.float32), (n, 1))
        )

    xyz = np.concatenate(pts)
    xyz += 0.005 * rng.standard_normal(xyz.shape)
    pc = np.concatenate(
        [xyz, np.concatenate(colors)], -1
    ).astype(np.float32)

    bbox = np.concatenate(
        [
            centers,
            sizes,
            headings[:, None],
            classes[:, None].astype(np.float64),
        ],
        -1,
    ).astype(np.float32)

    perm = rng.permutation(num_points)
    pc = pc[perm]
    votes = lineage_votes(pc[:, :3].astype(np.float64), bbox)
    return pc, bbox, votes


def write_dataset(root: str, scenes: int = 256, val_scenes: int = 64,
                  num_points: int = 20000, seed: int = 0):
    rng = np.random.default_rng(seed)
    for split, count, base in (("train", scenes, 0),
                               ("val", val_scenes, scenes)):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for i in range(count):
            pc, bbox, votes = oriented_scene(rng, num_points)
            idx = f"{base + i:06d}"
            np.save(os.path.join(d, f"{idx}_pc.npy"), pc)
            np.save(os.path.join(d, f"{idx}_bbox.npy"), bbox)
            np.save(os.path.join(d, f"{idx}_votes.npy"), votes)
    return root


def main(argv):
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    if "out" not in kv:
        raise SystemExit(__doc__)
    write_dataset(
        kv["out"],
        scenes=int(kv.get("scenes", 256)),
        val_scenes=int(kv.get("val_scenes", 64)),
        num_points=int(kv.get("points", 20000)),
        seed=int(kv.get("seed", 0)),
    )
    print(f"wrote {kv['out']}")


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
