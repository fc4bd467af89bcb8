"""Detector training loop (tpu3dsad/train_detector.py::run_detector).

One train step per batch on one device; synthetic batches made on the card
(`data.name=synthetic`, `data.device_synth=true`); JSON log lines at the
`log_every` steps and at each epoch's end; checkpoints with auto-resume.

Not ported yet, and refused with NotImplementedError before any step:
`evaluate` and AP with the best-mAP checkpoint, host-fed datasets
(Batcher, device_prefetch, packed), `steps_per_call > 1` (ROADMAP A7),
and a device mesh (ROADMAP A11).
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field

import torch

from tpu3dsad_torch import train_lib
from tpu3dsad_torch.data import get_dataset
from tpu3dsad_torch.data.device_pipeline import synthetic_detection_batch
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.utils.metrics import MetricsLogger


@dataclass
class TrainResult:
    """What run_detector leaves: the trained model and optimizer, the step
    it resumed from and the one it reached, and one record per step run
    ({"step", "loss", "seconds"}: host wall time of the step, which ends
    by reading its loss)."""

    model: SizeAdaptiveDetector
    optimizer: train_lib.Optimizer
    start_step: int
    step: int
    history: list = field(default_factory=list)


def build_detector(cfg, mean_sizes=None, *, device="cuda"):
    """The detector of cfg.model, weights drawn from cfg.train.seed."""
    return SizeAdaptiveDetector(
        cfg.model, mean_sizes, device=device,
        generator=torch.Generator().manual_seed(cfg.train.seed))


def _refuse_unported(cfg, k: int) -> None:
    if tuple(cfg.train.mesh_shape) not in ((-1,), (1,)):
        raise NotImplementedError(
            f"train.mesh_shape={cfg.train.mesh_shape}: training on a device "
            "mesh is not ported yet (ROADMAP A11)")
    if not cfg.data.device_synth:
        raise NotImplementedError(
            "host-fed batches (Batcher, device_prefetch) are not ported yet "
            "(ROADMAP A7); set data.device_synth=true")
    if k > 1:
        raise NotImplementedError(
            f"train.steps_per_call={cfg.train.steps_per_call}: fused k-step "
            "blocks are not ported yet (ROADMAP A7)")
    if cfg.train.eval_every <= cfg.train.num_epochs:
        raise NotImplementedError(
            f"train.eval_every={cfg.train.eval_every} would evaluate within "
            f"{cfg.train.num_epochs} epochs: evaluate / AP is not ported yet "
            "(ROADMAP A7); set eval_every above num_epochs")


def run_detector(cfg, *, device="cuda") -> TrainResult:
    """Train the detector of `cfg` (a Config) on `device`, the card unless
    the caller asks for the CPU; resume from cfg.train.ckpt_dir if it holds
    a checkpoint."""
    dataset = get_dataset(cfg)
    bs = cfg.train.batch_size
    steps_per_epoch, k = train_lib.round_steps_per_epoch(
        dataset.steps_per_epoch(bs), cfg.train.steps_per_call)
    _refuse_unported(cfg, k)
    train_lib.apply_runtime_config(cfg)

    model = build_detector(cfg, dataset.mean_sizes, device=device)
    optimizer = train_lib.make_optimizer(cfg.train, steps_per_epoch,
                                         model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"detector params: {n_params / 1e6:.2f}M", file=sys.stderr)
    start_step = train_lib.restore_checkpoint(cfg.train.ckpt_dir, model,
                                              optimizer)
    if start_step:
        print(f"resumed from step {start_step}", file=sys.stderr)
    warning = train_lib.check_and_record_train_meta(
        cfg.train.ckpt_dir, steps_per_epoch, k, resumed=bool(start_step))
    if warning:
        print(warning, file=sys.stderr)

    train_step = train_lib.make_detector_steps(model, optimizer, cfg)
    data_gen = torch.Generator(device=device).manual_seed(
        cfg.train.seed + 1234)
    step_gen = torch.Generator(device=device).manual_seed(cfg.train.seed + 1)

    def next_batch():
        return synthetic_detection_batch(
            data_gen, bs, cfg.data.num_points, cfg.model.num_classes,
            cfg.data.max_boxes, vote_candidates=cfg.data.vote_candidates)

    logger = MetricsLogger()
    result = TrainResult(model, optimizer, start_step, start_step)
    for epoch in range(start_step // steps_per_epoch, cfg.train.num_epochs):
        bn_m = train_lib.bn_momentum_at(cfg.train, epoch)
        t0 = time.perf_counter()
        for _ in range(steps_per_epoch):
            t_step = time.perf_counter()
            metrics = train_step(next_batch(), step_gen, bn_m)
            loss = float(metrics["loss"])  # waits for the step's kernels
            result.step += 1
            result.history.append({"step": result.step, "loss": loss,
                                   "seconds": time.perf_counter() - t_step})
            if result.step % cfg.train.log_every == 0:
                logger.log(result.step, {
                    "epoch": epoch,
                    **{n: round(float(v), 4) for n, v in metrics.items()}},
                    prefix="train/")
        dt = time.perf_counter() - t0
        print(json.dumps({"epoch": epoch, "epoch_time_s": round(dt, 2),
                          "scenes_per_sec": round(steps_per_epoch * bs / dt,
                                                  2)}), flush=True)
        if ((epoch + 1) % max(1, cfg.train.ckpt_every) == 0
                or epoch == cfg.train.num_epochs - 1):
            train_lib.save_checkpoint(cfg.train.ckpt_dir, model, optimizer,
                                      result.step)
    return result
