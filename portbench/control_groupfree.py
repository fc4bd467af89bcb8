#!/usr/bin/env python3
"""The controls of `correct` for eval-groupfree-scannet-b16 (the groupfree
driver). The plain reference is put in the program's place with a fault
planted in it, and each reading is a comparison that decides `correct`
(`mismatch_share` of the served slots, `kps_mismatch_share` of the KPS
picks as sets) against the sound reference; each fault must read above the
cell's limit in one of them:

  * tf32: the reference computed one precision below what the
    configuration states (both of torch's TF32 flags on);
  * plain_value: the value without its position term in both attentions
    (mmcv's plain MultiheadAttention in place of mmdet3d's GroupFree3DMHA);
  * layers_11: 11 decoder layers in place of 12 (the parse's last three
    stages are then the 9th to the 11th);
  * last_stage: the boxes of the last stage alone in place of the last
    three (256 a scene, not 768: every slot differs);
  * no_filter: the walk over every box, the non-empty filter left out.

Beside them it counts, over the checked batches, the boxes with more than
5 points in them, those the sound walk suppresses, and the boxes kept.
`box_count_mismatch_share` holds the kernel on its own inputs, so no fault
of the reference moves it; the card tests and chip_smoke.py hold the
kernel to the plain op besides.

    python3 portbench/control_groupfree.py --seeds 1,2,3

on one card, at the cell's own sizes. Prints one JSON line a seed. The
rooms and weights are the cell's, BatchNorm calibrated on the first batch
as the cell's set-up does.
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
from portbench.drivers.groupfree import (  # noqa: E402
    pick_mismatches,
    slot_mismatches,
)
from portbench.reference import compare  # noqa: E402
from portbench.reference import groupfree as reference  # noqa: E402
from portbench.traffic.detection import class_mean_sizes  # noqa: E402
from portbench.traffic.indoor import sweep_pool  # noqa: E402

CELL = "eval-groupfree-scannet-b16"


def plain_value_layer(net, name, q, k, qp, kp, padding, m):
    """reference.decoder_layer with the position terms added to the query
    and the key alone, not to the value (the fault of the plain_value
    control)."""
    heads, eps = m["groupfree_heads"], reference.LN_EPS
    u = q + qp
    q = reference.layer_norm(
        net, f"{name}.norm_0",
        q + reference.attention(net, f"{name}.self_attn", u, u, q, heads),
        eps)
    q = reference.layer_norm(
        net, f"{name}.norm_1",
        q + reference.attention(net, f"{name}.cross_attn", q + qp, k + kp,
                                k, heads, padding), eps)
    hidden = torch.relu(net.linear(f"{name}.ffn_in", q))
    return reference.layer_norm(net, f"{name}.norm_2",
                                q + net.linear(f"{name}.ffn_out", hidden),
                                eps)


# name -> (matmul, the decoder layer planted or None, serve's keywords;
# "layers" counts from the configuration's: -1 is one layer fewer, 11 of 12)
FAULTS = {
    "tf32": ("tf32", None, {}),
    "plain_value": ("fp32", plain_value_layer, {}),
    "layers_11": ("fp32", None, {"layers": -1}),
    "last_stage": ("fp32", None, {"stages": 1}),
    "no_filter": ("fp32", None, {"gate": False}),
}


def serve(params, config, sizes, batch, matmul, layer=None, **faults):
    """The reference's serve, with `layer` planted in place of its decoder
    layer where given."""
    sound = reference.decoder_layer
    reference.decoder_layer = layer or sound
    try:
        return reference.serve(params, config, sizes, *batch, matmul,
                               **faults)
    finally:
        reference.decoder_layer = sound


def controls(config: dict, w: dict, seed: int, device,
             faults=FAULTS) -> dict:
    pts, masks, checked = sweep_pool(np.random.default_rng(seed), w)
    sizes = class_mean_sizes(config["model"]["num_classes"])
    params = weights.draw(reference.shapes(config["model"]), seed, device)

    def batch(i):
        return (torch.from_numpy(pts[i]).to(device),
                torch.from_numpy(masks[i]).to(device))

    params = reference.calibrate(params, config, sizes, *batch(0), "fp32")
    slots = {name: [] for name in faults}
    picks = {name: [] for name in faults}
    nonempty = suppressed = kept = 0
    layers = config["model"]["groupfree_layers"]
    for i in sorted(checked):
        ref = serve(params, config, sizes, batch(i), "fp32")
        nonempty += int(ref["valid"].sum())
        suppressed += int(ref["valid"].sum() - ref["walked"].sum())
        kept += int(ref["keep"].sum())
        for name, (matmul, layer, kw) in faults.items():
            if "layers" in kw:
                kw = dict(kw, layers=layers + kw["layers"])
            got = serve(params, config, sizes, batch(i), matmul, layer, **kw)
            slots[name].append(slot_mismatches(got, ref))
            picks[name].append(pick_mismatches(got["picks"], ref["picks"]))
    return {"mismatch_share": {n: compare.share(c)
                               for n, c in slots.items()},
            "kps_mismatch_share": {n: compare.share(c)
                                   for n, c in picks.items()},
            "nonempty_boxes": nonempty, "suppressed_boxes": suppressed,
            "kept_boxes": kept}


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
