#!/usr/bin/env python3
"""The controls of `correct`: the plain reference put in the program's
place, computed one precision below what the configuration states, and
the training cells' faults planted in it, read by the same comparison
that decides `correct`. Each must read above the cell's limit.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

on the card, at the cell's own sizes (a training cell reads its faults
too). Prints one JSON line a seed: the readings by number. The lower
precision: TF32 for a configuration in fp32 with TF32 off, bf16 (autocast
of the MLP products) for one with TF32 products.
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
from portbench.reference import compare, detector, training  # noqa: E402
from portbench.traffic.detection import (  # noqa: E402
    class_mean_sizes,
    train_pool,
)
from portbench.traffic.indoor import (  # noqa: E402
    fit,
    fit_batch,
    frames,
    pick_checked,
    scan_pool,
    sweep_pool,
)

BELOW = {"fp32": "tf32", "tf32": "bf16"}


def serve_control(config: dict, workload: dict, seed: int, device,
                  seconds: float) -> dict:
    """mismatch_share of the reference one precision down against the
    reference, on the cell's checked batches (or the scans of the requests
    checked in a window of `seconds`) of this seed, both
    with the BatchNorm averages the reference calibrates as the cell's
    set-up calibrates the program's."""
    rng = np.random.default_rng(seed)
    sizes = class_mean_sizes(config["model"]["num_classes"])
    prec = "tf32" if config["train"]["bf16_matmul"] else "fp32"
    if workload["driver"] == "sweep":
        pts, masks, checked = sweep_pool(rng, workload)
        batches = [(torch.from_numpy(pts[i]), torch.from_numpy(masks[i]))
                   for i in [0, *sorted(checked)]]
    else:
        raws, order = scan_pool(rng, workload)
        due = frames(seconds, workload["rate_hz"])
        scans = sorted({int(order[k % len(order)]) for k in pick_checked(
            seed, due, workload["check_scenes"])})
        batches = [fit_batch(raws[:workload["calibrate"]],
                             workload["budget"])]
        batches += [fit(raws[i], workload["budget"]) for i in scans]
    batches = [(p.to(device), m.to(device)) for p, m in batches]
    params = weights.draw(weights.detector_shapes(config["model"]), seed,
                          device)
    params = detector.calibrate(params, config, sizes, *batches[0], prec)
    counts = []
    for p, m in batches[1:]:
        ref = detector.serve(params, config, sizes, p, m, prec)
        low = detector.serve(params, config, sizes, p, m, BELOW[prec])
        if workload["driver"] == "sweep":
            counts.append(compare.slot_mismatches(low, ref))
        else:
            counts.append(compare.box_mismatches(compare.detections(low),
                                                 compare.detections(ref)))
    return {"mismatch_share": compare.share(counts)}


def train_control(config: dict, workload: dict, seed: int, device) -> dict:
    """The training gaps of the reference one precision down, and of the
    half-batch fault, against the reference, over the cell's checked
    steps of this seed; and of a state left unchanged (no run)."""
    pool, aug_seed = train_pool(np.random.default_rng(seed), workload, config)
    params = weights.draw(weights.detector_shapes(config["model"]), seed,
                          device)
    sizes = class_mean_sizes(config["model"]["num_classes"])
    batches = [{n: torch.from_numpy(v[i]).to(device) for n, v in pool.items()}
               for i in range(workload["check_steps"])]
    prec = "tf32" if config["train"]["bf16_matmul"] else "fp32"

    def follow(matmul, half=False):
        gen = torch.Generator(device=device).manual_seed(aug_seed)
        return training.follow(params, config, sizes, batches, gen, matmul,
                               half_batch=half)

    ref = follow(prec)
    unchanged = dict(ref, change={n: 0.0 for n in ref["change"]})
    return {"control": compare.train_gaps(follow(BELOW[prec]), ref),
            "half_batch": compare.train_gaps(follow(prec, half=True), ref),
            "state_unchanged": compare.train_gaps(unchanged, ref)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    workload = json.loads((ROOT / "portbench" / "workloads"
                           / f"{args.workload}.json").read_text())
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        if workload["driver"] == "train":
            got = train_control(config, workload, seed, device)
        else:
            got = serve_control(config, workload, seed, device,
                                bench["run_seconds"])
        print(json.dumps({"workload": args.workload, "seed": seed, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
