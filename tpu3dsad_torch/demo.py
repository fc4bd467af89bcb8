"""Demo entry point: run the detector on one scene and dump the boxes
(the port's counterpart of the root demo.py).

    python -m tpu3dsad_torch.demo train.ckpt_dir=./ckpt [out=DIR] \\
        [device=cpu] [overrides...]

One train batch of one scene from default_rng(7) of the configured
dataset, the newest checkpoint under train.ckpt_dir (eval.use_best: the
best snapshot; random weights from train.seed where there is none), then
forward + parse_predictions. Writes detections.json ({"ckpt_step",
"detections"}), points.npy and, through utils/dump.py, points.ply with
pred_boxes.obj and gt_boxes.obj where there are boxes. Runs on the card
unless device=cpu is given.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from tpu3dsad_torch import train_lib
from tpu3dsad_torch.config import parse_cli
from tpu3dsad_torch.data import get_dataset
from tpu3dsad_torch.eval.parse import parse_predictions
from tpu3dsad_torch.train_detector import build_detector
from tpu3dsad_torch.utils.dump import dump_results


def main(argv) -> dict:
    """Returns what detections.json holds."""
    out_dir, device, rest = "/tmp/tpu3dsad_demo", "cuda", []
    for a in argv:
        key, _, value = a.partition("=")
        if key == "out":
            out_dir = value
        elif key == "device":
            device = value
        else:
            rest.append(a)
    cfg = parse_cli(rest)
    train_lib.apply_runtime_config(cfg)
    dataset = get_dataset(cfg, device=device)
    model = build_detector(cfg, dataset.mean_sizes, device=device)

    batch_np = dataset.train_batch(np.random.default_rng(7), 1)
    batch = {k: torch.from_numpy(np.asarray(v)).to(device)
             for k, v in batch_np.items()}
    step = train_lib.restore_checkpoint(cfg.train.ckpt_dir, model, None,
                                        for_eval=True,
                                        use_best=cfg.eval.use_best)
    model.eval()
    with torch.no_grad():
        end_points = model(batch["points"], batch.get("point_features"),
                           mask=batch["point_mask"])
        parsed = parse_predictions(end_points, model.mean_sizes,
                                   cfg.model.num_heading_bins, cfg.eval)
    host = {k: v.cpu().numpy() for k, v in parsed.items()}

    os.makedirs(out_dir, exist_ok=True)
    dets = [
        {
            "center": host["center"][0, p].tolist(),
            "size": host["size"][0, p].tolist(),
            "heading": float(host["heading"][0, p]),
            "class": int(host["sem_cls"][0, p]),
            "score": float(host["obj_prob"][0, p]),
        }
        for p in np.nonzero(host["keep"][0])[0]
    ]
    result = {"ckpt_step": step, "detections": dets}
    with open(os.path.join(out_dir, "detections.json"), "w") as f:
        json.dump(result, f, indent=1)
    np.save(os.path.join(out_dir, "points.npy"), batch_np["points"][0])
    dump_results(out_dir, batch_np, host, scene=0)
    print(f"wrote {len(dets)} detections to {out_dir}/ (json + ply + obj)")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
