"""Shape-family OFF meshes in the raw ModelNet layout
(tpu3dsad/data/synthetic_shapes.py, pure numpy; for one seed it writes
byte-identical files).

Real ModelNet40 is not in the repository. This writer makes ten
geometrically distinct families (box, sphere, cylinder, cone, torus,
pyramid, table, stairs, cross, wall) as OFF meshes under
``<root>/<class>/{train,test}/<name>.off``, so the whole classification
path runs on them: ``preproc_modelnet`` surface sampling -> the .npy
contract -> ``data/modelnet.py`` (unit-sphere normalisation, augmentation)
-> classifier training, where a val accuracy of 0.9 or more is the target.
Each item jitters its aspect, its rotation about z, a small tilt and its
family's own parameters (step count, leg thickness, torus radii).

CLI:
  python -m tpu3dsad_torch.data.synthetic_shapes out=<dir> [per_class=64]
      [test_per_class=16] [seed=0]
then:
  python -m tpu3dsad_torch.data.preproc_modelnet root=<dir> out=<npy> \\
      num_points=4096
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

SHAPE_CLASSES = (
    "box", "sphere", "cylinder", "cone", "torus",
    "pyramid", "table", "stairs", "cross", "wall",
)


# ---------------------------------------------------------------- mesh parts
def _box(center, size):
    """Cuboid → (verts [8,3], faces [12,3])."""
    c = np.asarray(center, float)
    h = np.asarray(size, float) / 2
    sgn = np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], float
    )
    verts = c + sgn * h
    faces = np.array(
        [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],  # x faces
         [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],  # y faces
         [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]]  # z faces
    )
    return verts, faces


def _uv_sphere(radius, rings=9, segs=16):
    th = np.linspace(0, np.pi, rings + 2)[1:-1]
    ph = np.linspace(0, 2 * np.pi, segs, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    grid = radius * np.stack(
        [np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)], -1
    ).reshape(-1, 3)
    verts = np.concatenate([grid, [[0, 0, radius], [0, 0, -radius]]])
    top, bot = len(verts) - 2, len(verts) - 1
    faces = []
    for i in range(rings - 1):
        for j in range(segs):
            a = i * segs + j
            b = i * segs + (j + 1) % segs
            faces += [[a, b, a + segs], [b, b + segs, a + segs]]
    for j in range(segs):  # caps
        faces += [[top, j, (j + 1) % segs],
                  [bot, (rings - 1) * segs + (j + 1) % segs,
                   (rings - 1) * segs + j]]
    return verts, np.asarray(faces)


def _lathe(profile_r, profile_z, segs=16, close_top=True, close_bot=True):
    """Surface of revolution: profile (r_i, z_i) swept around +Z."""
    ph = np.linspace(0, 2 * np.pi, segs, endpoint=False)
    rows = []
    for r, z in zip(profile_r, profile_z):
        rows.append(
            np.stack([r * np.cos(ph), r * np.sin(ph),
                      np.full(segs, float(z))], -1)
        )
    verts = np.concatenate(rows)
    faces = []
    for i in range(len(rows) - 1):
        for j in range(segs):
            a, b = i * segs + j, i * segs + (j + 1) % segs
            faces += [[a, b, a + segs], [b, b + segs, a + segs]]
    if close_bot and profile_r[0] > 0:
        c = len(verts)
        verts = np.concatenate([verts, [[0, 0, profile_z[0]]]])
        faces += [[c, (j + 1) % segs, j] for j in range(segs)]
    if close_top and profile_r[-1] > 0:
        c = len(verts)
        base = (len(rows) - 1) * segs
        verts = np.concatenate([verts, [[0, 0, profile_z[-1]]]])
        faces += [[c, base + j, base + (j + 1) % segs] for j in range(segs)]
    return verts, np.asarray(faces)


def _torus(R, r, seg_u=16, seg_v=10):
    u = np.linspace(0, 2 * np.pi, seg_u, endpoint=False)
    v = np.linspace(0, 2 * np.pi, seg_v, endpoint=False)
    U, V = np.meshgrid(u, v, indexing="ij")
    verts = np.stack(
        [(R + r * np.cos(V)) * np.cos(U),
         (R + r * np.cos(V)) * np.sin(U),
         r * np.sin(V)], -1
    ).reshape(-1, 3)
    faces = []
    for i in range(seg_u):
        for j in range(seg_v):
            a = i * seg_v + j
            b = i * seg_v + (j + 1) % seg_v
            c = ((i + 1) % seg_u) * seg_v + j
            d = ((i + 1) % seg_u) * seg_v + (j + 1) % seg_v
            faces += [[a, b, c], [b, d, c]]
    return verts, np.asarray(faces)


def _merge(*parts):
    verts, faces, off = [], [], 0
    for v, f in parts:
        verts.append(v)
        faces.append(np.asarray(f) + off)
        off += len(v)
    return np.concatenate(verts), np.concatenate(faces)


# ------------------------------------------------------------ shape families
def make_shape(family: str, rng: np.random.Generator):
    """One jittered instance of a family → (verts, faces)."""
    a = rng.uniform(0.7, 1.4, 3)  # anisotropic aspect
    if family == "box":
        v, f = _box([0, 0, 0], [1.6 * a[0], 1.1 * a[1], 0.9 * a[2]])
    elif family == "sphere":
        v, f = _uv_sphere(0.8)
        v = v * a  # ellipsoid jitter
    elif family == "cylinder":
        r, h = 0.45 * a[0], 1.6 * a[2]
        v, f = _lathe([r, r], [-h / 2, h / 2])
    elif family == "cone":
        r, h = 0.7 * a[0], 1.5 * a[2]
        v, f = _lathe([r, 1e-3], [-h / 2, h / 2])
    elif family == "torus":
        v, f = _torus(0.7 * a[0], rng.uniform(0.15, 0.28))
    elif family == "pyramid":
        s = 1.3 * a[0]
        base, fb = _box([0, 0, -0.05], [s, s * a[1], 0.1])
        apex = np.array([[0, 0, 1.2 * a[2]]])
        corners = np.array(
            [[-s / 2, -s * a[1] / 2, 0], [s / 2, -s * a[1] / 2, 0],
             [s / 2, s * a[1] / 2, 0], [-s / 2, s * a[1] / 2, 0]]
        )
        vv = np.concatenate([corners, apex])
        ff = np.array([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4],
                       [0, 2, 1], [0, 3, 2]])
        v, f = _merge((base, fb), (vv, ff))
    elif family == "table":
        top, ft = _box([0, 0, 0.75], [1.6 * a[0], 1.0 * a[1], 0.1])
        leg_t = rng.uniform(0.06, 0.12)
        legs = [
            _box([sx * 0.7 * a[0], sy * 0.4 * a[1], 0.35],
                 [leg_t, leg_t, 0.7])
            for sx in (-1, 1) for sy in (-1, 1)
        ]
        v, f = _merge((top, ft), *legs)
    elif family == "stairs":
        k = int(rng.integers(3, 6))
        steps = [
            _box([0.4 * i * a[0], 0, 0.2 * (i + 0.5) * a[2]],
                 [0.4 * a[0], 1.2 * a[1], 0.2 * a[2] * (i + 1)])
            for i in range(k)
        ]
        v, f = _merge(*steps)
    elif family == "cross":
        b1 = _box([0, 0, 0], [2.0 * a[0], 0.35 * a[1], 0.35 * a[2]])
        b2 = _box([0, 0, 0], [0.35 * a[0], 2.0 * a[1], 0.35 * a[2]])
        v, f = _merge(b1, b2)
    elif family == "wall":
        # thin L-shaped wall: tall, flat, concave corner
        w1 = _box([0, 0, 0.8], [1.8 * a[0], 0.08, 1.6 * a[2]])
        w2 = _box([0.9 * a[0], 0.6 * a[1], 0.8], [0.08, 1.2 * a[1], 1.6 * a[2]])
        v, f = _merge(w1, w2)
    else:
        raise ValueError(f"unknown family {family!r}")

    # rigid jitter: z-rotation + small tilt (the loader re-normalizes scale)
    th = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(th), np.sin(th)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    tilt = rng.uniform(-0.12, 0.12, 2)
    cx, sx = np.cos(tilt[0]), np.sin(tilt[0])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return (v @ rot.T @ rx.T), f


def write_off(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as fh:
        fh.write("OFF\n")
        fh.write(f"{len(verts)} {len(faces)} 0\n")
        for p in verts:
            fh.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for t in faces:
            fh.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def generate(out: str, per_class: int = 64, test_per_class: int = 16,
             seed: int = 0) -> dict:
    counts = {"train": 0, "test": 0}
    for ci, fam in enumerate(SHAPE_CLASSES):
        for si, (split, n) in enumerate(
            (("train", per_class), ("test", test_per_class))
        ):
            d = os.path.join(out, fam, split)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                # tuple seeding → SeedSequence entropy mixing: no stream
                # collisions between splits/classes at ANY per_class (an
                # arithmetic scheme leaked identical meshes into train and
                # test once per_class exceeded the split offset)
                rng = np.random.default_rng((seed, ci, si, i))
                v, f = make_shape(fam, rng)
                write_off(os.path.join(d, f"{fam}_{i:04d}.off"), v, f)
                counts[split] += 1
    return counts


def main(argv):
    kv = dict(a.split("=", 1) for a in argv)
    if "out" not in kv:
        print(__doc__)
        return 2
    counts = generate(
        kv["out"],
        per_class=int(kv.get("per_class", 64)),
        test_per_class=int(kv.get("test_per_class", 16)),
        seed=int(kv.get("seed", 0)),
    )
    print(json.dumps({"written": counts, "classes": list(SHAPE_CLASSES),
                      "out": kv["out"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
