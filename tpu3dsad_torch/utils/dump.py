"""Visualization dumps: PLY point clouds, OBJ box wireframes
(tpu3dsad/utils/dump.py, byte for byte its files).

Lineage: utils/pc_util.write_ply + models/dump_helper.dump_results.
Dependency-free ASCII writers.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    """points [N,3] float; colors [N,3] uint8 optional."""
    points = np.asarray(points, np.float32)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]:.4f} {points[i, 1]:.4f} {points[i, 2]:.4f}"
            if colors is not None:
                row += f" {int(colors[i, 0])} {int(colors[i, 1])} {int(colors[i, 2])}"
            f.write(row + "\n")


_BOX_EDGES = (
    (0, 1), (1, 2), (2, 3), (3, 0),  # top
    (4, 5), (5, 6), (6, 7), (7, 4),  # bottom
    (0, 4), (1, 5), (2, 6), (3, 7),  # verticals
)


def write_boxes_obj(path: str, corners: np.ndarray):
    """corners [G, 8, 3] -> OBJ wireframe (lines)."""
    corners = np.asarray(corners, np.float32)
    with open(path, "w") as f:
        for g in range(len(corners)):
            for c in corners[g]:
                f.write(f"v {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
        for g in range(len(corners)):
            base = g * 8 + 1
            for a, b in _BOX_EDGES:
                f.write(f"l {base + a} {base + b}\n")


def dump_results(out_dir: str, batch: dict, parsed: dict, scene: int = 0):
    """Write one scene's points + predicted and GT boxes for inspection.
    batch: numpy arrays; parsed: parse_predictions' fields (tensors on any
    device, or numpy)."""
    from tpu3dsad_torch.ops.boxes import box_corners

    os.makedirs(out_dir, exist_ok=True)
    pts = np.asarray(batch["points"][scene])
    mask = np.asarray(batch["point_mask"][scene]).astype(bool)
    write_ply(os.path.join(out_dir, "points.ply"), pts[mask])

    keep = _numpy(parsed["keep"][scene]).astype(bool)
    if keep.any():
        write_boxes_obj(
            os.path.join(out_dir, "pred_boxes.obj"),
            _numpy(parsed["corners"][scene])[keep],
        )
    gmask = np.asarray(batch["gt_mask"][scene]).astype(bool)
    if gmask.any():
        gt_corners = box_corners(
            *(torch.from_numpy(np.asarray(batch[k][scene]))
              for k in ("gt_centers", "gt_sizes", "gt_headings"))
        ).numpy()[gmask]
        write_boxes_obj(os.path.join(out_dir, "gt_boxes.obj"), gt_corners)


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
