"""Check an extracted dataset directory against the loaders' on-disk .npy
contracts before a training run (tpu3dsad/data/validate.py; for the same
files it reports the reference's errors and warnings).

Checks every scene file of `<root>/{train,val}` for the dataset family's
contract (shapes, dtypes, value ranges, agreement between files; see the
loaders' docstrings: data/scannet.py, data/sunrgbd.py, data/kitti.py, and
the ModelNet layout of the reference's data/modelnet.py). Each message
names the file and the field. The exit code is nonzero when any error is
found.

Usage:
  python -m tpu3dsad_torch.data.validate data.name=scannet root=/d/scannet
  python -m tpu3dsad_torch.data.validate data.name=sunrgbd root=/d/sunrgbd \
      max_scenes=50        # the first 50 scenes of each split
"""

from __future__ import annotations

import json
import os
import sys
from glob import glob

import numpy as np


class Report:
    def __init__(self):
        self.errors: list[str] = []
        self.warnings: list[str] = []
        self.scenes = 0

    def err(self, path, field, msg):
        self.errors.append(f"{path} [{field}]: {msg}")

    def warn(self, path, field, msg):
        self.warnings.append(f"{path} [{field}]: {msg}")


def _load(rep: Report, path: str):
    try:
        return np.load(path)
    except Exception as e:
        rep.err(path, "file", f"unreadable npy: {e}")
        return None


def _check_finite(rep, path, field, arr):
    if not np.isfinite(arr).all():
        rep.err(path, field, "contains NaN/Inf")


def _check_points(rep, d, name, pc_path, min_cols, kind):
    pc = _load(rep, pc_path)
    if pc is None:
        return None
    if pc.ndim != 2 or pc.shape[1] < min_cols:
        rep.err(pc_path, "shape",
                f"expected [N,>={min_cols}] ({kind}), got {list(pc.shape)}")
        return None
    if not np.issubdtype(pc.dtype, np.floating):
        rep.err(pc_path, "dtype", f"expected float, got {pc.dtype}")
    if pc.shape[0] == 0:
        rep.err(pc_path, "N", "empty point cloud")
    _check_finite(rep, pc_path, "xyz", pc[:, :3])
    return pc


def _check_bbox(rep, bbox_path, cols, cls_col, valid_cls, cls_desc):
    bb = _load(rep, bbox_path)
    if bb is None:
        return None
    if bb.ndim != 2 or bb.shape[1] != cols:
        rep.err(bbox_path, "shape",
                f"expected [G,{cols}], got {list(bb.shape)}")
        return None
    if len(bb):
        _check_finite(rep, bbox_path, "box params", bb)
        sizes = bb[:, 3:6]
        if (sizes <= 0).any():
            rep.err(bbox_path, "dx dy dz",
                    f"non-positive extent rows: "
                    f"{np.nonzero((sizes <= 0).any(1))[0].tolist()[:5]}")
        cls = bb[:, cls_col]
        if not np.isin(cls.astype(np.int64), list(valid_cls)).all():
            bad = sorted(set(cls.astype(np.int64).tolist()) - set(valid_cls))
            rep.warn(bbox_path, f"col {cls_col} ({cls_desc})",
                     f"ids {bad[:8]} are not in the benchmark set — those "
                     "boxes will be DROPPED by the loader")
    return bb


# ------------------------------------------------------------- per-dataset


def validate_scannet_scene(rep: Report, d: str, scan: str):
    from tpu3dsad_torch.data.scannet import NYU40_IDS

    vert_p = os.path.join(d, f"{scan}_vert.npy")
    pc = _check_points(rep, d, scan, vert_p, 3, "xyz(+rgb)")
    if pc is not None and pc.shape[1] not in (3, 6):
        rep.warn(vert_p, "cols",
                 f"{pc.shape[1]} columns (3=xyz or 6=xyz+rgb expected); "
                 "extra columns are ignored")
    if pc is not None and pc.shape[1] >= 6:
        rgb = pc[:, 3:6]
        if rgb.size and rgb.max() <= 1.0 + 1e-6:
            rep.warn(vert_p, "rgb",
                     "rgb looks 0-1 normalized; the loader expects 0-255 "
                     "(trains on rgb/256)")
    n = None if pc is None else pc.shape[0]
    for suffix, desc in (("ins_label", "instance id"),
                         ("sem_label", "nyu40 semantic id")):
        p = os.path.join(d, f"{scan}_{suffix}.npy")
        lab = _load(rep, p)
        if lab is None:
            continue
        if lab.ndim != 1:
            rep.err(p, "shape", f"expected [N] ({desc}), got {list(lab.shape)}")
            continue
        if n is not None and lab.shape[0] != n:
            rep.err(p, "N", f"{lab.shape[0]} labels vs {n} vertices")
        if not np.issubdtype(lab.dtype, np.integer):
            rep.err(p, "dtype", f"expected integer, got {lab.dtype}")
        elif len(lab) and lab.min() < 0:
            rep.err(p, desc, f"negative ids (min {lab.min()})")
    _check_bbox(rep, os.path.join(d, f"{scan}_bbox.npy"),
                cols=7, cls_col=6, valid_cls=NYU40_IDS, cls_desc="nyu40 id")


def validate_sunrgbd_scene(rep: Report, d: str, idx: str):
    pc_p = os.path.join(d, f"{idx}_pc.npy")
    pc = _check_points(rep, d, idx, pc_p, 6, "xyz+rgb(0-1)")
    if pc is not None:
        rgb = pc[:, 3:6]
        if rgb.size and rgb.max() > 1.5:
            rep.warn(pc_p, "rgb",
                     f"rgb max {rgb.max():.1f} looks 0-255; the sunrgbd "
                     "contract stores 0-1")
    _check_bbox(rep, os.path.join(d, f"{idx}_bbox.npy"),
                cols=8, cls_col=7, valid_cls=range(10), cls_desc="cls 0..9")
    votes_p = os.path.join(d, f"{idx}_votes.npy")
    if os.path.exists(votes_p):
        v = _load(rep, votes_p)
        if v is not None:
            # [N,4] (mask,dxyz) or the lineage GT_VOTE_FACTOR=3 layout
            # [N,>=10] (mask + 3 candidate offsets) — both accepted by the
            # loader (data/sunrgbd.py) and written by preproc_sunrgbd
            if v.ndim != 2 or (v.shape[1] != 4 and v.shape[1] < 10):
                rep.err(votes_p, "shape",
                        "expected [N,4] (mask,dx,dy,dz) or [N,>=10] "
                        f"(mask + 3 candidate offsets), got {list(v.shape)}")
            else:
                if pc is not None and v.shape[0] != pc.shape[0]:
                    rep.err(votes_p, "N",
                            f"{v.shape[0]} vote rows vs {pc.shape[0]} points")
                m = v[:, 0]
                if not np.isin(m, (0.0, 1.0)).all():
                    rep.err(votes_p, "mask col 0",
                            "values outside {0,1}")
                _check_finite(rep, votes_p, "offsets", v[:, 1:])


def validate_kitti_scene(rep: Report, d: str, idx: str):
    from tpu3dsad_torch.data.kitti import RANGE_MAX, RANGE_MIN

    pc_p = os.path.join(d, f"{idx}_pc.npy")
    pc = _check_points(rep, d, idx, pc_p, 4, "xyz+intensity")
    if pc is not None:
        inside = np.all(
            (pc[:, :3] >= RANGE_MIN) & (pc[:, :3] <= RANGE_MAX), axis=1
        )
        if not inside.any():
            rep.err(pc_p, "range crop",
                    "no point falls inside the front range box "
                    f"[{RANGE_MIN.tolist()} .. {RANGE_MAX.tolist()}] — "
                    "wrong frame? (velodyne: x forward, z up)")
    _check_bbox(rep, os.path.join(d, f"{idx}_bbox.npy"),
                cols=8, cls_col=7, valid_cls=range(3), cls_desc="cls 0..2")


def validate_modelnet_scene(rep: Report, d: str, name: str):
    pc_p = os.path.join(d, f"{name}_pts.npy")
    _check_points(rep, d, name, pc_p, 3, "xyz(+normals)")
    lab_p = os.path.join(d, f"{name}_label.npy")
    lab = _load(rep, lab_p)
    if lab is None:
        return
    if np.asarray(lab).size != 1:
        rep.err(lab_p, "shape",
                f"expected scalar class id, got {list(np.shape(lab))}")
    elif not np.issubdtype(np.asarray(lab).dtype, np.integer):
        rep.err(lab_p, "dtype", f"expected integer, got {np.asarray(lab).dtype}")
    elif int(np.asarray(lab).reshape(())) < 0:
        rep.err(lab_p, "class id", f"negative id {int(np.asarray(lab).reshape(()))}")


_FAMILIES = {
    "scannet": ("_vert.npy", validate_scannet_scene),
    "sunrgbd": ("_pc.npy", validate_sunrgbd_scene),
    "kitti": ("_pc.npy", validate_kitti_scene),
    "modelnet": ("_pts.npy", validate_modelnet_scene),
}


def validate_root(name: str, root: str, max_scenes: int | None = None) -> Report:
    if name not in _FAMILIES:
        raise SystemExit(
            f"data.name={name!r} has no .npy contract to validate "
            f"(families: {sorted(_FAMILIES)})"
        )
    anchor, scene_fn = _FAMILIES[name]
    rep = Report()
    if not os.path.isdir(root):
        rep.err(root, "root", "not a directory")
        return rep
    for split in ("train", "val"):
        d = os.path.join(root, split)
        if split == "val" and not os.path.isdir(d) and os.path.isdir(
                os.path.join(root, "test")):
            d = os.path.join(root, "test")  # loaders treat test==val
        if not os.path.isdir(d):
            (rep.err if split == "train" else rep.warn)(
                d, "split", "missing split directory"
            )
            continue
        ids = sorted(
            os.path.basename(p)[: -len(anchor)]
            for p in glob(os.path.join(d, f"*{anchor}"))
        )
        if not ids:
            rep.err(d, "scenes", f"no *{anchor} files found")
            continue
        for sid in ids[:max_scenes]:
            scene_fn(rep, d, sid)
            rep.scenes += 1
    return rep


def main(argv):
    name, root, max_scenes = "", "", None
    for a in argv:
        if a.startswith("data.name="):
            name = a.split("=", 1)[1]
        elif a.startswith(("root=", "data.root=")):
            root = a.split("=", 1)[1]
        elif a.startswith("max_scenes="):
            max_scenes = int(a.split("=", 1)[1])
        else:
            raise SystemExit(f"unknown arg {a!r} (see module docstring)")
    if not name or not root:
        raise SystemExit(
            "usage: python -m tpu3dsad_torch.data.validate data.name=<ds> "
            "root=<dir>"
        )
    rep = validate_root(name, root, max_scenes)
    for w in rep.warnings:
        print(f"WARN  {w}")
    for e in rep.errors:
        print(f"ERROR {e}")
    print(json.dumps({
        "dataset": name, "root": root, "scenes_checked": rep.scenes,
        "errors": len(rep.errors), "warnings": len(rep.warnings),
        "ok": not rep.errors,
    }))
    return 1 if rep.errors else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
