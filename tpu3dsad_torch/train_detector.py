"""Detector training loop and val sweep (tpu3dsad/train_detector.py:
run_detector, evaluate).

run_detector: one train step per batch on one device; synthetic batches
made on the card (`data.name=synthetic`, `data.device_synth=true`); JSON
log lines at the `log_every` steps and at each epoch's end; checkpoints
with auto-resume.

evaluate: the val sweep of a dataset with host val batches (KITTI,
config #4) -> AP table, on one device.

Not ported yet, and refused with NotImplementedError before any step:
evaluating inside training (the synthetic dataset's host val batches,
ROADMAP A7.2), host-fed training batches (Batcher, device_prefetch,
ROADMAP A7.2 / A7.5), `steps_per_call > 1` (ROADMAP A7.3), and a device
mesh (ROADMAP A11).
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu3dsad_torch import train_lib
from tpu3dsad_torch.data import get_dataset
from tpu3dsad_torch.data.device_pipeline import synthetic_detection_batch
from tpu3dsad_torch.eval.ap import APCalculator
from tpu3dsad_torch.eval.parse import parse_groundtruths, predictions_to_lists
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
            "(ROADMAP A7.2, A7.5); set data.device_synth=true")
    if k > 1:
        raise NotImplementedError(
            f"train.steps_per_call={cfg.train.steps_per_call}: fused k-step "
            "blocks are not ported yet (ROADMAP A7.3)")
    if cfg.train.eval_every <= cfg.train.num_epochs:
        raise NotImplementedError(
            f"train.eval_every={cfg.train.eval_every} would evaluate within "
            f"{cfg.train.num_epochs} epochs: the synthetic dataset's host val "
            "batches are not ported yet (ROADMAP A7.2); set eval_every above "
            "num_epochs")


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


def evaluate(cfg, model, dataset, eval_step, parse, num_batches=None):
    """Val sweep -> AP table, on the model's device (the reference's
    evaluate with one device and no mesh).

    Each val batch goes to the device with its scene_mask, which marks the
    tail batch's padding scenes: the eval step's loss leaves them out and
    AP never scores them. parse(end_points) gives the parsed fields; their
    per-scene lists and the ground truth are scored on the host.

    Returns {"val_loss", "mAP@t", "AR@t", "per_class@t": {name: AP}} for
    every t in cfg.eval.ap_iou_threshs, rounded to 4 places."""
    device = next(model.parameters()).device
    calc = {t: APCalculator(iou_thresh=t, class_names=dataset.class_names)
            for t in cfg.eval.ap_iou_threshs}
    rng = np.random.default_rng(12345)
    losses, loss_weights = [], []
    for i, batch_np in enumerate(dataset.val_batches(rng,
                                                     cfg.train.batch_size)):
        if num_batches is not None and i >= num_batches:
            break
        scene_mask = np.asarray(batch_np.pop(
            "scene_mask", np.ones(cfg.train.batch_size, bool)))
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in batch_np.items()}
        batch["scene_mask"] = torch.from_numpy(scene_mask).to(device)
        end_points, metrics = eval_step(batch)
        losses.append(float(metrics["loss"]))
        loss_weights.append(float(scene_mask.mean()))
        parsed = {k: v.cpu().numpy() for k, v in parse(end_points).items()}
        preds = predictions_to_lists(parsed, cfg.eval, cfg.model.num_classes)
        gts = parse_groundtruths(batch_np)
        preds = [p for p, v in zip(preds, scene_mask) if v]
        gts = [g for g, v in zip(gts, scene_mask) if v]
        for c in calc.values():
            c.step(preds, gts)
    out = {"val_loss": round(float(np.average(losses, weights=loss_weights)),
                             4) if losses else None}
    for t, c in calc.items():
        m = c.compute_metrics()
        out[f"mAP@{t}"] = round(m["mAP"], 4)
        out[f"AR@{t}"] = round(m["AR"], 4)
        out[f"per_class@{t}"] = {k[: -len(" AP")]: round(v, 4)
                                 for k, v in m.items() if k.endswith(" AP")}
    return out
