"""Training entry point for the detector and the classifier (the
reference's root train.py).

    python -m tpu3dsad_torch.train model.name=detector data.name=scannet \\
        data.root=/data/scannet [key=value ...]
    python -m tpu3dsad_torch.train preset=classifier [key=value ...]

Config overrides are `section.key=value` pairs (tpu3dsad_torch/config.py,
presets in presets.py). The config goes to stderr, then model.name picks
train_detector.run_detector or train_classifier.run_classifier. Runs on
the card; `main(argv, device="cpu")` runs on the CPU.

Data parallelism: start one process a rank with torchrun,

    python -m torch.distributed.run --standalone --nproc-per-node=P \
        -m tpu3dsad_torch.train [key=value ...]

and each joins the process group (parallel/launch.py: cuda:LOCAL_RANK and
NCCL on the card, gloo on the CPU); train.mesh_shape (-1: every rank)
splits train.batch_size, the global batch, over the axis 'data'.
"""

from __future__ import annotations

import sys

from tpu3dsad_torch import train_lib
from tpu3dsad_torch.config import describe, parse_cli
from tpu3dsad_torch.parallel.launch import ranks_from_env
from tpu3dsad_torch.train_classifier import run_classifier
from tpu3dsad_torch.train_detector import UNTRAINED, run_detector

RUNNERS = {"detector": run_detector, "classifier": run_classifier}


def main(argv, *, device="cuda"):
    """Train the model of the command line `argv`; returns the runner's
    result (train_detector.TrainResult or
    train_classifier.ClassifierResult)."""
    cfg = parse_cli(argv)
    print(describe(cfg), file=sys.stderr)
    train_lib.apply_runtime_config(cfg)
    if cfg.model.name in UNTRAINED:
        raise SystemExit(UNTRAINED[cfg.model.name])
    runner = RUNNERS.get(cfg.model.name)
    if runner is None:
        raise SystemExit(f"unknown model.name={cfg.model.name}")
    with ranks_from_env(device) as ranked:
        return runner(cfg, device=ranked or device)


if __name__ == "__main__":
    main(sys.argv[1:])
