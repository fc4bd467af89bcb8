"""Synthetic indoor scenes written in the ScanNet on-disk contract
(tpu3dsad/data/synthetic_indoor.py, pure numpy; for one seed it writes
byte-identical files).

No ScanNet release is in the repository, so the host-fed training path of
config #3 (data/scannet.py, then data/packed.py and the train step's
augmentation on the card) runs on fabricated scenes in the exact contract
the loader documents:

  <scan>_vert.npy       float32 [N, 6]  xyz + rgb(0-255)
  <scan>_ins_label.npy  int32   [N]     instance id (0 = unannotated)
  <scan>_sem_label.npy  int32   [N]     nyu40 semantic id
  <scan>_bbox.npy       float32 [G, 7]  cx cy cz dx dy dz nyu40_cls

The scenes follow data/synthetic.py's detection scenes, with axis-aligned
boxes, object sizes from SCANNET_MEAN_SIZES, unannotated floor (nyu40 2)
and walls (nyu40 1) that the loader must leave out of supervision, and
objects that may overlap, which gives candidate votes (V > 1) work.

CLI:
    python -m tpu3dsad_torch.data.synthetic_indoor out=/path [scenes=256]
        [val_scenes=64] [points=20000] [seed=0]
"""

from __future__ import annotations

import os

import numpy as np

from tpu3dsad_torch.data.scannet import NYU40_IDS, SCANNET_MEAN_SIZES


def indoor_scene(rng: np.random.Generator, num_points: int = 20000,
                 max_objects: int = 8, min_objects: int = 3):
    """One ScanNet-style scene.

    Returns (verts [N,6] float32, ins [N] int32, sem [N] int32,
    bbox [G,7] float32). Object points are drawn on box surfaces so
    centers are analytic; each instance gets a flat rgb color.
    """
    room = float(rng.uniform(4.0, 7.0))
    g = int(rng.integers(min_objects, max_objects + 1))
    classes = rng.integers(0, len(NYU40_IDS), g)
    sizes = SCANNET_MEAN_SIZES[classes] * rng.uniform(0.8, 1.25, (g, 3))
    centers = np.stack(
        [
            rng.uniform(-room / 2 + 1, room / 2 - 1, g),
            rng.uniform(-room / 2 + 1, room / 2 - 1, g),
            sizes[:, 2] / 2,  # sitting on the floor
        ],
        -1,
    ).astype(np.float32)

    # point budget: floor ~22%, walls ~8%, the rest split over objects
    n_floor = int(0.22 * num_points)
    n_wall = int(0.08 * num_points)
    n_obj_total = num_points - n_floor - n_wall
    per = np.full(g, n_obj_total // g)
    per[: n_obj_total - per.sum()] += 1

    pts, ins, sem = [], [], []
    floor = np.stack(
        [
            rng.uniform(-room / 2, room / 2, n_floor),
            rng.uniform(-room / 2, room / 2, n_floor),
            0.01 * rng.standard_normal(n_floor),
        ],
        -1,
    )
    pts.append(floor)
    ins.append(np.zeros(n_floor, np.int32))          # unannotated
    sem.append(np.full(n_floor, 2, np.int32))        # nyu40 floor

    side = rng.integers(0, 4, n_wall)
    along = rng.uniform(-room / 2, room / 2, n_wall)
    wx = np.where(side < 2, along, np.where(side == 2, -room / 2, room / 2))
    wy = np.where(side < 2, np.where(side == 0, -room / 2, room / 2), along)
    walls = np.stack([wx, wy, rng.uniform(0.0, 2.4, n_wall)], -1)
    walls += 0.01 * rng.standard_normal(walls.shape)
    pts.append(walls)
    ins.append(np.zeros(n_wall, np.int32))
    sem.append(np.ones(n_wall, np.int32))            # nyu40 wall

    for i in range(g):
        # surface-of-box sampling (same construction as synthetic.make_shape
        # 'cube', inlined to keep this module loader-independent)
        n = int(per[i])
        cube = rng.uniform(-0.5, 0.5, (n, 3))
        ax = rng.integers(0, 3, n)
        cube[np.arange(n), ax] = 0.5 * rng.choice([-1.0, 1.0], n)
        pts.append(cube * sizes[i] + centers[i])
        ins.append(np.full(n, i + 1, np.int32))      # ids are 1-based
        sem.append(np.full(n, NYU40_IDS[classes[i]], np.int32))

    xyz = np.concatenate(pts).astype(np.float32)
    xyz += 0.005 * rng.standard_normal(xyz.shape).astype(np.float32)
    ins = np.concatenate(ins)
    sem = np.concatenate(sem)

    # flat per-instance color (0 = gray structure)
    palette = rng.integers(30, 226, (g + 1, 3)).astype(np.float32)
    palette[0] = 128.0
    verts = np.concatenate([xyz, palette[ins]], -1).astype(np.float32)

    perm = rng.permutation(num_points)
    bbox = np.concatenate(
        [
            centers,
            sizes.astype(np.float32),
            np.asarray(NYU40_IDS, np.float32)[classes][:, None],
        ],
        -1,
    ).astype(np.float32)
    return verts[perm], ins[perm], sem[perm], bbox


def write_dataset(root: str, scenes: int = 256, val_scenes: int = 64,
                  num_points: int = 20000, seed: int = 0):
    rng = np.random.default_rng(seed)
    for split, count, base in (("train", scenes, 0),
                               ("val", val_scenes, scenes)):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for i in range(count):
            verts, ins, sem, bbox = indoor_scene(rng, num_points)
            scan = f"scene{base + i:04d}_00"
            np.save(os.path.join(d, f"{scan}_vert.npy"), verts)
            np.save(os.path.join(d, f"{scan}_ins_label.npy"), ins)
            np.save(os.path.join(d, f"{scan}_sem_label.npy"), sem)
            np.save(os.path.join(d, f"{scan}_bbox.npy"), bbox)
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
