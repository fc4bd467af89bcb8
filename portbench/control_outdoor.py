#!/usr/bin/env python3
"""The controls of `correct` for eval-kitti-b8 (the outdoor driver), which
control.py does not know. The plain reference is put in the program's
place with a fault planted in it, and each reading is a comparison that
decides `correct` (`mismatch_share` of the served slots,
`iou_mismatch_share` of the NMS's IoU over the overlapping pairs) against
the sound reference; each fault must read above the cell's limit in one
of them:

  * tf32: the reference computed one precision below what the
    configuration states;
  * aabb_iou: NMS by the axis-aligned bird's-eye-view IoU of each box's
    footprint (the box's heading ignored) in place of the oriented IoU;
  * no_iou: NMS by an IoU of 0 everywhere, so that nothing is suppressed.

Beside them it counts, over the checked batches, the valid boxes, those
the sound walk suppresses and the pairs of boxes that overlap (those the
IoU's comparison holds): no_iou's
`mismatch_share` is the suppressed share of the served slots, and where
the walk suppresses few, only the IoU's own comparison tells one IoU from
another.

    python3 portbench/control_outdoor.py --seeds 1,2,3

on one card, at the cell's own sizes. Prints one JSON line a seed. Both
sides are fitted by the reference's own crop and FPS, BatchNorm
calibrated on the first batch as the cell's set-up does.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import weights  # noqa: E402
from portbench.drivers.outdoor import iou_share  # noqa: E402
from portbench.reference import compare, detector, outdoor  # noqa: E402
from portbench.traffic.outdoor import KITTI_MEAN_SIZES, scan_pool  # noqa: E402

CELL = "eval-kitti-b8"


def aabb_iou(corners_a: torch.Tensor, corners_b: torch.Tensor):
    """The wrong IoU planted by the aabb_iou control: the 2D IoU of the
    axis-aligned rectangles that hold each box's footprint."""
    a, b = corners_a.double(), corners_b.double()
    lo_a, hi_a = a[..., :2].amin(-2), a[..., :2].amax(-2)  # [..., K, 2]
    lo_b, hi_b = b[..., :2].amin(-2), b[..., :2].amax(-2)
    lo = torch.maximum(lo_a[..., :, None, :], lo_b[..., None, :, :])
    hi = torch.minimum(hi_a[..., :, None, :], hi_b[..., None, :, :])
    inter = (hi - lo).clamp_min(0).prod(-1)
    area_a = (hi_a - lo_a).prod(-1)[..., :, None]
    area_b = (hi_b - lo_b).prod(-1)[..., None, :]
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-30), 0.0)


def no_iou(corners_a: torch.Tensor, corners_b: torch.Tensor):
    return corners_a.new_zeros(corners_a.shape[:-2]
                               + corners_b.shape[-3:-2]).double()


def serve(params, config, points, mask, matmul, iou=None):
    """The reference's six fields, with `iou` planted in place of its
    oriented IoU where given."""
    sound = outdoor.oriented_iou
    outdoor.oriented_iou = iou or sound
    try:
        return outdoor.serve(params, config, KITTI_MEAN_SIZES, points, mask,
                             matmul)
    finally:
        outdoor.oriented_iou = sound


def controls(config: dict, w: dict, seed: int, device) -> dict:
    scans, checked = scan_pool(np.random.default_rng(seed), w)
    params = weights.draw(weights.detector_shapes(config["model"]), seed,
                          device)

    def fitted(i):
        return outdoor.fit(torch.from_numpy(scans[i]).to(device),
                           w["budget"])[:2]

    params = detector.calibrate(params, config, KITTI_MEAN_SIZES,
                                *fitted(0), "fp32")
    planted = {"tf32": ("tf32", None), "aabb_iou": ("fp32", aabb_iou),
               "no_iou": ("fp32", no_iou)}
    slots = {name: [] for name in planted}
    pairs = {name: [] for name in planted}
    valid = kept = overlapping = 0
    for i in sorted(checked):
        points, mask = fitted(i)
        ref = serve(params, config, points, mask, "fp32")
        valid += int(ref["valid"].sum())
        kept += int(ref["keep"].sum())
        overlapping += outdoor.iou_mismatches(ref["iou"], ref["iou"],
                                              ref["size"])[1]
        for name, (matmul, iou) in planted.items():
            got = serve(params, config, points, mask, matmul, iou)
            slots[name].append(compare.slot_mismatches(got, ref))
            pairs[name].append(outdoor.iou_mismatches(
                got["iou"], ref["iou"], ref["size"]))
    return {"mismatch_share": {n: compare.share(c)
                               for n, c in slots.items()},
            "iou_mismatch_share": {n: iou_share(c, [True])
                                   for n, c in pairs.items()},
            "valid_boxes": valid, "suppressed_boxes": valid - kept,
            "overlapping_pairs": overlapping}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    w = json.loads((ROOT / "portbench" / "workloads"
                    / f"{CELL}.json").read_text())
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": CELL, "seed": seed,
                          **controls(config, w, seed, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
