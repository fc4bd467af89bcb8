"""Raw KITTI object-detection files -> the outdoor .npy contract
(tpu3dsad/data/preproc_kitti.py, pure numpy; for one input it writes
byte-identical files). It reads the standard KITTI object layout

  <root>/<split>/velodyne/<idx>.bin   float32 [N, 4] xyz + intensity (velo)
  <root>/<split>/label_2/<idx>.txt    camera-frame labels:
      type trunc occl alpha bbox2d(4) h w l x y z ry
  <root>/<split>/calib/<idx>.txt      P0..P3, R0_rect (9), Tr_velo_to_cam (12)

and writes per scene what `data/kitti.py` reads:

  <idx>_pc.npy    float32 [N, 4]  xyz + intensity, velodyne frame (Z-up)
  <idx>_bbox.npy  float32 [G, 8]  cx cy cz dx dy dz heading cls: velodyne
                                  frame, full extents (dx=l dy=w dz=h),
                                  heading about +Z, cls in {car=0,
                                  pedestrian=1, cyclist=2}

The frame conversion, in float64: the label location (x, y, z) is the
box's bottom centre in rectified-camera coordinates; it maps to the
velodyne frame by inv(Tr_velo_to_cam) @ inv(R0_rect) (homogeneous), then
rises h/2 to the box centre. The camera yaw ry (about camera +Y, from
camera +X) becomes the velodyne heading -ry - pi/2 (about +Z, from
velodyne +X). Types other than Car, Pedestrian and Cyclist (Van, Truck,
DontCare, ...) are dropped, as in the family's 3-class benchmark.

CLI:
  python -m tpu3dsad_torch.data.preproc_kitti root=/data/kitti \\
      out=/data/kitti_npy [split=training] [train_list=train.txt] \\
      [val_list=val.txt]

Scenes in val_list go to out/val, the rest (or train_list) to out/train.
"""

from __future__ import annotations

import json
import os
import sys
from glob import glob

import numpy as np

KITTI_TYPE_TO_CLS = {"Car": 0, "Pedestrian": 1, "Cyclist": 2}


def read_calib(path: str) -> dict:
    """R0_rect [4,4] and Tr_velo_to_cam [4,4] as homogeneous matrices."""
    vals = {}
    with open(path) as f:
        for line in f:
            if ":" in line:
                key, rest = line.split(":", 1)
                vals[key.strip()] = np.array(rest.split(), np.float64)
    out = {}
    r0 = np.eye(4)
    r0[:3, :3] = vals["R0_rect"].reshape(3, 3)
    out["R0_rect"] = r0
    tr = np.eye(4)
    tr[:3, :4] = vals["Tr_velo_to_cam"].reshape(3, 4)
    out["Tr_velo_to_cam"] = tr
    return out


def read_labels(path: str, calib: dict) -> np.ndarray:
    """label_2 txt → [G, 8] velodyne-frame boxes (module docstring)."""
    rect_to_velo = np.linalg.inv(calib["R0_rect"] @ calib["Tr_velo_to_cam"])
    boxes = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0] not in KITTI_TYPE_TO_CLS:
                continue
            h, w, length = (float(v) for v in tok[8:11])
            xyz_rect = np.array([*(float(v) for v in tok[11:14]), 1.0])
            ry = float(tok[14])
            bottom = rect_to_velo @ xyz_rect
            center = bottom[:3] / bottom[3]
            center[2] += h / 2  # label location is the box bottom-center
            heading = -ry - np.pi / 2
            boxes.append(
                [*center, length, w, h, heading, KITTI_TYPE_TO_CLS[tok[0]]]
            )
    return (
        np.asarray(boxes, np.float32) if boxes else np.zeros((0, 8), np.float32)
    )


def read_velodyne(path: str) -> np.ndarray:
    pc = np.fromfile(path, np.float32)
    if pc.size % 4:
        raise ValueError(f"{path}: velodyne bin size not a multiple of 4")
    return pc.reshape(-1, 4)


def export_scene(root: str, split: str, idx: str) -> dict:
    pc = read_velodyne(os.path.join(root, split, "velodyne", idx + ".bin"))
    calib = read_calib(os.path.join(root, split, "calib", idx + ".txt"))
    bbox = read_labels(
        os.path.join(root, split, "label_2", idx + ".txt"), calib
    )
    return {"pc": pc, "bbox": bbox}


def _read_list(path):
    if not path:
        return None
    with open(path) as f:
        return {line.strip() for line in f if line.strip()}


def export_all(root: str, out: str, split: str = "training",
               train_list=None, val_list=None) -> dict:
    ids = sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob(os.path.join(root, split, "velodyne", "*.bin"))
    )
    if not ids:
        raise FileNotFoundError(
            f"no velodyne/*.bin under {os.path.join(root, split)}"
        )
    train_set, val_set = _read_list(train_list), _read_list(val_list)
    counts = {"train": 0, "val": 0}
    for idx in ids:
        if val_set is not None and idx in val_set:
            dest = "val"
        elif train_set is None or idx in train_set:
            dest = "train"
        else:
            continue
        arrays = export_scene(root, split, idx)
        d = os.path.join(out, dest)
        os.makedirs(d, exist_ok=True)
        for key, arr in arrays.items():
            np.save(os.path.join(d, f"{idx}_{key}.npy"), arr)
        counts[dest] += 1
    return counts


def main(argv):
    kv = dict(a.split("=", 1) for a in argv)
    if not {"root", "out"} <= set(kv):
        print(__doc__)
        return 2
    try:
        counts = export_all(
            kv["root"], kv["out"], kv.get("split", "training"),
            kv.get("train_list"), kv.get("val_list"),
        )
    except (OSError, ValueError, KeyError) as e:
        print(f"preproc_kitti: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"written": counts, "out": kv["out"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
