#!/usr/bin/env python3
"""The controls of `correct` for eval-3dssd-kitti-b16 (the ssd3d driver).
The plain reference is put in the program's place with a fault planted in
it, and each reading is a comparison that decides `correct`
(`pick_mismatch_share` of every sampler's picks, `mismatch_share` of the
served slots, `iou_mismatch_share` of the NMS's IoU over the overlapping
pairs) against the sound reference; each fault must read above the cell's
limit in one of them:

  * tf32: the reference computed one precision below what the
    configuration states (both of torch's TF32 flags on);
  * dfps: D-FPS by xyz alone in the place of each F-FPS;
  * aabb_iou: NMS by the axis-aligned bird's-eye-view IoU of each box's
    footprint (the box's heading ignored) in place of the oriented IoU.

Beside them it counts, over the checked batches, the valid boxes, those
the sound walk suppresses, those the top-100 cut drops, and the pairs of
boxes that overlap (those the IoU's comparison holds).

    python3 portbench/control_ssd3d.py --seeds 1,2,3

on one card, at the cell's own sizes. Prints one JSON line a seed. The
scans are fitted by the reference's own crop and FPS
(reference/outdoor.py::fit), BatchNorm calibrated on the first batch as
the cell's set-up does.
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
from portbench.control_outdoor import aabb_iou  # noqa: E402
from portbench.drivers.outdoor import iou_share  # noqa: E402
from portbench.drivers.ssd3d import FIELDS, pick_mismatches  # noqa: E402
from portbench.reference import compare, outdoor, ssd3d  # noqa: E402
from portbench.traffic.outdoor import scan_pool  # noqa: E402

CELL = "eval-3dssd-kitti-b16"


def dfps_for_ffps(vec, m, mask):
    """The fault planted by the dfps control: D-FPS by the vector's xyz."""
    return ssd3d.dfps(vec[..., :3].contiguous(), m, mask)


def serve(params, config, batch, matmul, ffps=None, iou=None):
    """The reference's serve, with `ffps` and `iou` planted in place of its
    F-FPS and oriented IoU where given."""
    sound = ssd3d.ffps, ssd3d.oriented_iou
    ssd3d.ffps = ffps or sound[0]
    ssd3d.oriented_iou = iou or sound[1]
    try:
        return ssd3d.serve(params, config, *batch, matmul)
    finally:
        ssd3d.ffps, ssd3d.oriented_iou = sound


def controls(config: dict, w: dict, seed: int, device) -> dict:
    scans, checked = scan_pool(np.random.default_rng(seed), w)
    params = weights.draw(ssd3d.shapes(config["model"]), seed, device)

    def fitted(i):
        raw = torch.from_numpy(scans[i]).to(device)
        points, mask, rows = outdoor.fit(raw, w["budget"])
        feats = torch.zeros(*mask.shape, 1, device=device)
        for b, r in enumerate(rows):
            feats[b, :r.shape[0], 0] = raw[b, r, 3]
        return points, feats, mask

    params = ssd3d.calibrate(params, config, *fitted(0), "fp32")
    planted = {"tf32": ("tf32", None, None),
               "dfps": ("fp32", dfps_for_ffps, None),
               "aabb_iou": ("fp32", None, aabb_iou)}
    picks = {name: [] for name in planted}
    slots = {name: [] for name in planted}
    pairs = {name: [] for name in planted}
    valid = kept = walked = overlapping = 0
    for i in sorted(checked):
        batch = fitted(i)
        ref = serve(params, config, batch, "fp32")
        valid += int(ref["valid"].sum())
        kept += int(ref["keep"].sum())
        walked += int(outdoor.greedy(ref["iou"], ref["obj_prob"],
                                     ref["valid"],
                                     config["eval"]["nms_iou"]).sum())
        overlapping += outdoor.iou_mismatches(ref["iou"], ref["iou"],
                                              ref["size"])[1]
        fields = {k: ref[k] for k in FIELDS}
        for name, (matmul, ffps, iou) in planted.items():
            got = serve(params, config, batch, matmul, ffps, iou)
            picks[name].append(pick_mismatches(got["picks"], ref["picks"]))
            slots[name].append(compare.slot_mismatches(
                {k: got[k] for k in FIELDS}, fields))
            pairs[name].append(outdoor.iou_mismatches(
                got["iou"], ref["iou"], ref["size"]))
    return {"pick_mismatch_share": {n: compare.share(c)
                                    for n, c in picks.items()},
            "mismatch_share": {n: compare.share(c)
                               for n, c in slots.items()},
            "iou_mismatch_share": {n: iou_share(c, [True])
                                   for n, c in pairs.items()},
            "valid_boxes": valid, "suppressed_boxes": valid - walked,
            "past_the_top": walked - kept,
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
