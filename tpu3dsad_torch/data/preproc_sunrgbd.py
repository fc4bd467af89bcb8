"""Raw SUN RGB-D data -> the extracted .npy detection contract, without
MATLAB (tpu3dsad/data/preproc_sunrgbd.py, numpy + scipy.io + PIL; for one
input it writes byte-identical files).

  inputs:
    meta=SUNRGBDMeta3DBB_v2.mat    per-scene struct array: depthpath,
                                   rgbpath, Rtilt [3,3], K [3,3],
                                   groundtruth3DBB (basis [3,3] rows,
                                   coeffs half-extents, centroid,
                                   classname, ...), v1 or v2 file
    root=<dir holding SUNRGBD/>    image tree; the meta's absolute paths
                                   are re-rooted at the 'SUNRGBD/' segment

  outputs under out/{train,val} (what data/sunrgbd.py reads):
    <idx>_pc.npy     float32 [N, 6]  upright-depth xyz (Z-up) + rgb(0-1)
    <idx>_bbox.npy   float32 [G, 8]  cx cy cz dx dy dz heading cls (0..9)
    <idx>_votes.npy  float32 [N, 10] mask + 3 candidate centre offsets
                                     (data/sunrgbd.py::lineage_votes)

Depth as the SUNRGBD toolbox reads it (read3dPoints.m): uint16 pixels
bit-rotated (d>>3 | d<<13), in metres (/1000), capped at 8 m; pixel
(u, v), 1-based, back-projected through K, axes swapped to (x, depth, -y),
then rotated by Rtilt into the upright frame; zero-depth pixels dropped.
Boxes: the toolbox basis rows are the box axes with coeffs the
half-extents; the most vertical row becomes z, dx/dy/dz = 2 coeffs in
(x, y, z) order and the heading is atan2 of the x row. Classes outside the
10-class benchmark are dropped.

PIL (the Pillow package) reads the images and scipy.io the meta, both
imported at first use. Where PIL does not import, `read_depth` raises an
ImportError naming this converter and PIL; it has no other way to read
the depth maps.

CLI:
  python -m tpu3dsad_torch.data.preproc_sunrgbd meta=SUNRGBDMeta3DBB_v2.mat \\
      root=/data/root out=/data/sunrgbd [val_list=val_idxs.txt] \\
      [num_points=50000]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from tpu3dsad_torch.data.sunrgbd import SUNRGBD_CLASS_NAMES, lineage_votes

_CLS = {n: i for i, n in enumerate(SUNRGBD_CLASS_NAMES)}


def _pil_image():
    """PIL's Image module, imported at first use; an ImportError that
    names this converter where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "preproc_sunrgbd reads the depth and colour images with PIL "
            "(the Pillow package), which does not import here") from e
    return Image


def read_depth(path: str) -> np.ndarray:
    """SUNRGBD 16-bit depth png → meters [H, W] (toolbox bit-rotation,
    8 m cap)."""
    Image = _pil_image()
    raw = np.asarray(Image.open(path), np.uint16)
    meters = (
        np.bitwise_or(raw >> 3, raw << 13).astype(np.float32) / 1000.0
    )
    return np.minimum(meters, 8.0)


def depth_to_points(depth: np.ndarray, k: np.ndarray,
                    rtilt: np.ndarray, rgb=None) -> np.ndarray:
    """[H, W] meters → [N, 6] upright xyz + rgb(0-1); zero-depth dropped."""
    h, w = depth.shape
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    u, v = np.meshgrid(
        np.arange(1, w + 1, dtype=np.float32),
        np.arange(1, h + 1, dtype=np.float32),
    )
    x3 = (u - cx) * depth / fx
    y3 = (v - cy) * depth / fy
    cam = np.stack([x3, depth, -y3], -1).reshape(-1, 3)
    valid = depth.reshape(-1) > 0
    pts = cam[valid] @ np.asarray(rtilt, np.float32).T
    colors = (
        np.asarray(rgb, np.float32).reshape(-1, 3)[valid] / 255.0
        if rgb is not None
        else np.zeros_like(pts)
    )
    return np.concatenate([pts, colors], 1).astype(np.float32)


def convert_box(basis: np.ndarray, coeffs: np.ndarray,
                centroid: np.ndarray, classname: str):
    """Toolbox OBB → our [8] row, or None for a non-benchmark class."""
    cls = _CLS.get(str(classname))
    if cls is None:
        return None
    basis = np.asarray(basis, np.float64).reshape(3, 3)
    coeffs = np.abs(np.asarray(coeffs, np.float64).reshape(3))
    zi = int(np.argmax(np.abs(basis[:, 2])))
    order = [i for i in range(3) if i != zi] + [zi]
    basis, coeffs = basis[order], coeffs[order]
    heading = float(np.arctan2(basis[0, 1], basis[0, 0]))
    return np.array(
        [*np.asarray(centroid, np.float64).reshape(3),
         *(coeffs * 2), heading, cls],
        np.float32,
    )


def _local_path(root: str, meta_path: str) -> str:
    """Re-root the meta's absolute path at its 'SUNRGBD/' segment."""
    parts = str(meta_path).replace("\\", "/").split("/")
    if "SUNRGBD" in parts:
        parts = parts[parts.index("SUNRGBD"):]
    return os.path.join(root, *parts)


def read_meta(mat_path: str):
    """SUNRGBDMeta3DBB_v2.mat → list of per-scene dicts."""
    from scipy.io import loadmat

    mat = loadmat(mat_path, squeeze_me=True, struct_as_record=False)
    key = next(k for k in mat if not k.startswith("__"))
    metas = np.atleast_1d(mat[key])
    scenes = []
    for m in metas:
        groups = getattr(m, "groundtruth3DBB", None)
        rows = []
        if groups is not None and np.size(groups):
            for g in np.atleast_1d(groups):
                row = convert_box(g.basis, g.coeffs, g.centroid, g.classname)
                if row is not None:
                    rows.append(row)
        scenes.append({
            "depthpath": str(m.depthpath),
            "rgbpath": str(getattr(m, "rgbpath", "")),
            "Rtilt": np.asarray(m.Rtilt, np.float64).reshape(3, 3),
            "K": np.asarray(m.K, np.float64).reshape(3, 3),
            "bbox": (
                np.stack(rows) if rows else np.zeros((0, 8), np.float32)
            ),
        })
    return scenes


def export_scene(scene: dict, root: str, num_points: int = 50000,
                 seed: int = 0) -> dict:
    depth = read_depth(_local_path(root, scene["depthpath"]))
    rgb = None
    rgb_path = _local_path(root, scene["rgbpath"]) if scene["rgbpath"] else ""
    if rgb_path and os.path.exists(rgb_path):
        rgb = np.asarray(_pil_image().open(rgb_path).convert("RGB"))
        if rgb.shape[:2] != depth.shape:
            raise ValueError(
                f"{rgb_path}: rgb {rgb.shape[:2]} does not register with "
                f"depth {depth.shape}"
            )
    pc = depth_to_points(depth, scene["K"], scene["Rtilt"], rgb)
    if len(pc) > num_points:
        sel = np.random.default_rng(seed).choice(
            len(pc), num_points, replace=False
        )
        pc = pc[sel]
    bbox = scene["bbox"]
    return {
        "pc": pc,
        "bbox": bbox,
        "votes": lineage_votes(pc[:, :3], bbox),
    }


def _read_list(path):
    if not path:
        return None
    with open(path) as f:
        return {line.strip() for line in f if line.strip()}


def export_all(meta: str, root: str, out: str, val_list=None,
               num_points: int = 50000) -> dict:
    scenes = read_meta(meta)
    val_set = _read_list(val_list) or set()
    counts = {"train": 0, "val": 0}
    for i, scene in enumerate(scenes):
        idx = f"{i + 1:06d}"  # lineage 1-based image ids
        split = "val" if idx in val_set else "train"
        arrays = export_scene(scene, root, num_points, seed=i)
        d = os.path.join(out, split)
        os.makedirs(d, exist_ok=True)
        for key, arr in arrays.items():
            np.save(os.path.join(d, f"{idx}_{key}.npy"), arr)
        counts[split] += 1
    return counts


def main(argv):
    kv = dict(a.split("=", 1) for a in argv)
    if not {"meta", "root", "out"} <= set(kv):
        print(__doc__)
        return 2
    try:
        counts = export_all(
            kv["meta"], kv["root"], kv["out"], kv.get("val_list"),
            int(kv.get("num_points", 50000)),
        )
    except (OSError, ValueError, KeyError) as e:
        print(f"preproc_sunrgbd: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"written": counts, "out": kv["out"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
