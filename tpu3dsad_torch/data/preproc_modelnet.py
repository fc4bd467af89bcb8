"""Raw ModelNet distributions -> the classification .npy contract
(tpu3dsad/data/preproc_modelnet.py, pure numpy; for one input it writes
byte-identical files). Two raw layouts are accepted:

1. ``modelnet40_normal_resampled`` (what the lineage loader reads):

     <root>/<class>/<class>_XXXX.txt      comma-separated x,y,z[,nx,ny,nz]
     <root>/modelnet40_shape_names.txt    class names, one per line (the
                                          order gives the class id)
     <root>/modelnet40_train.txt          item names (e.g. airplane_0001)
     <root>/modelnet40_test.txt

2. The original ModelNet OFF meshes:

     <root>/<class>/{train,test}/<name>.off

   Meshes become point clouds by area-weighted uniform sampling on the
   triangles (``num_points`` samples, seeded per item, so a rerun writes
   the same cloud byte for byte).

Both write what `data/modelnet.py` reads under ``<out>/{train,val}/``:

  <name>_pts.npy    float32 [N, 3+]  xyz first; normals kept when present
  <name>_label.npy  int32   scalar   class id

Class ids come from ``modelnet40_shape_names.txt`` where present, else
from the sorted class directories, and are recorded in
``<out>/class_names.txt``. The raw test split lands in ``out/val``.

CLI:
  python -m tpu3dsad_torch.data.preproc_modelnet root=/data/modelnet40 \\
      out=/data/modelnet_npy [num_points=10000] [max_items=N]
"""

from __future__ import annotations

import json
import os
import sys
import zlib
from glob import glob

import numpy as np


def read_off(path: str) -> tuple[np.ndarray, np.ndarray]:
    """OFF mesh → (vertices [V,3] f64, faces [F,3] int). Handles the
    malformed ModelNet files whose counts share the ``OFF`` header line
    (e.g. ``OFF490 518 0``) and fans out polygon faces."""
    with open(path) as f:
        tokens = f.read().split()
    if not tokens:
        raise ValueError(f"{path}: empty OFF file")
    head = tokens[0]
    if head == "OFF":
        rest = tokens[1:]
    elif head.startswith("OFF"):
        rest = [head[3:]] + tokens[1:]
    else:
        raise ValueError(f"{path}: not an OFF file (header {head!r})")
    nv, nf = int(rest[0]), int(rest[1])
    cur = 3  # skip edge count
    verts = np.array(rest[cur:cur + 3 * nv], np.float64).reshape(nv, 3)
    cur += 3 * nv
    faces = []
    for _ in range(nf):
        k = int(rest[cur])
        poly = [int(v) for v in rest[cur + 1:cur + 1 + k]]
        cur += 1 + k
        # triangle-fan any polygon face
        faces.extend((poly[0], poly[i], poly[i + 1]) for i in range(1, k - 1))
    if not faces:
        raise ValueError(f"{path}: no triangular faces")
    return verts, np.asarray(faces, np.int64)


def sample_mesh(verts: np.ndarray, faces: np.ndarray, n: int,
                rng: np.random.Generator) -> np.ndarray:
    """Area-weighted uniform surface sampling → [n,3] float32."""
    a, b, c = (verts[faces[:, i]] for i in range(3))
    cross = np.cross(b - a, c - a)
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total = area.sum()
    if total <= 0:  # degenerate mesh: fall back to vertex resampling
        sel = rng.choice(len(verts), n, replace=len(verts) < n)
        return verts[sel].astype(np.float32)
    tri = rng.choice(len(faces), n, p=area / total)
    # uniform barycentric draw (sqrt trick keeps it uniform over the tri)
    r1 = np.sqrt(rng.random((n, 1)))
    r2 = rng.random((n, 1))
    pts = (1 - r1) * a[tri] + r1 * (1 - r2) * b[tri] + r1 * r2 * c[tri]
    return pts.astype(np.float32)


def _class_names(root: str) -> list[str]:
    names_file = os.path.join(root, "modelnet40_shape_names.txt")
    if os.path.exists(names_file):
        with open(names_file) as f:
            return [line.strip() for line in f if line.strip()]
    return sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d))
    )


def _read_list(root: str, split: str):
    p = os.path.join(root, f"modelnet40_{split}.txt")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return [line.strip() for line in f if line.strip()]


def _item_class(name: str, classes: set) -> str:
    # airplane_0001 → airplane; night_stand_0042 → night_stand
    stem = name.rsplit("_", 1)[0]
    if stem not in classes:
        raise KeyError(f"item {name!r}: class {stem!r} not in shape names")
    return stem


def export_resampled(root: str, out: str, names: list[str],
                     max_items=None) -> dict:
    cls_id = {c: i for i, c in enumerate(names)}
    counts = {"train": 0, "val": 0}
    for split, dest in (("train", "train"), ("test", "val")):
        items = _read_list(root, split)
        if items is None:
            raise FileNotFoundError(
                f"{root}: modelnet40_{split}.txt missing (resampled layout)"
            )
        d = os.path.join(out, dest)
        os.makedirs(d, exist_ok=True)
        for name in items[:max_items]:
            cls = _item_class(name, set(names))
            pts = np.loadtxt(
                os.path.join(root, cls, name + ".txt"),
                delimiter=",", dtype=np.float32, ndmin=2,
            )
            if pts.shape[1] < 3:
                raise ValueError(f"{name}: expected >=3 columns, got "
                                 f"{pts.shape[1]}")
            np.save(os.path.join(d, f"{name}_pts.npy"), pts)
            np.save(os.path.join(d, f"{name}_label.npy"),
                    np.int32(cls_id[cls]))
            counts[dest] += 1
    return counts


def export_off(root: str, out: str, names: list[str], num_points: int,
               max_items=None) -> dict:
    cls_id = {c: i for i, c in enumerate(names)}
    counts = {"train": 0, "val": 0}
    for cls in names:
        for split, dest in (("train", "train"), ("test", "val")):
            files = sorted(glob(os.path.join(root, cls, split, "*.off")))
            d = os.path.join(out, dest)
            os.makedirs(d, exist_ok=True)
            for path in files[:max_items]:
                name = os.path.splitext(os.path.basename(path))[0]
                verts, faces = read_off(path)
                # per-item seed: stable across runs and item orderings
                # (hash() is salted per process — crc32 is not)
                seed = zlib.crc32(f"{cls}/{name}".encode())
                pts = sample_mesh(verts, faces, num_points,
                                  np.random.default_rng(seed))
                np.save(os.path.join(d, f"{name}_pts.npy"), pts)
                np.save(os.path.join(d, f"{name}_label.npy"),
                        np.int32(cls_id[cls]))
                counts[dest] += 1
    return counts


def export_all(root: str, out: str, num_points: int = 10000,
               max_items=None) -> dict:
    names = _class_names(root)
    if not names:
        raise FileNotFoundError(f"{root}: no class directories/shape names")
    resampled = _read_list(root, "train") is not None
    if resampled:
        counts = export_resampled(root, out, names, max_items)
    else:
        counts = export_off(root, out, names, num_points, max_items)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "class_names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return {"layout": "resampled" if resampled else "off", **counts}


def main(argv):
    kv = dict(a.split("=", 1) for a in argv)
    if not {"root", "out"} <= set(kv):
        print(__doc__)
        return 2
    try:
        counts = export_all(
            kv["root"], kv["out"], int(kv.get("num_points", 10000)),
            int(kv["max_items"]) if "max_items" in kv else None,
        )
    except (OSError, ValueError, KeyError) as e:
        print(f"preproc_modelnet: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"written": counts, "out": kv["out"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
