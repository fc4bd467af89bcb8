"""Detector training loop and val sweep (tpu3dsad/train_detector.py:
run_detector, evaluate).

run_detector: train steps, one a call, or, with train.steps_per_call =
k > 1, k a call (train_lib.make_detector_train_block: on the card a CUDA
graph of one step replayed k times; on a mesh of more than one rank, and
on the CPU, k eager steps; rank 0 prints the block's mode on stderr).
The batches come from the dataset's host loader (`train_batch`, on a
Batcher thread, then `device_prefetch` to the card; at k > 1 one draw of
k x B scenes a call, stacked [k, B, ...]), or, for data.name=synthetic with
data.device_synth=true, are made on the card (inside the block at k > 1).
The loss is read once a call. JSON log lines at the `log_every` steps and
at each epoch's end; checkpoints with auto-resume; every `eval_every`
epochs the val sweep, its metrics logged under eval/, and the best-mAP
snapshot kept (train_lib.save_best_checkpoint). train.tb_dir adds
TensorBoard scalars (utils/metrics.py); train.profile_dir traces the
first epoch run with torch.profiler into <profile_dir>/trace.json, with
the program's tracer on (utils/trace.py: its spans are ranges of that
trace, and their records <profile_dir>/spans.jsonl), and a resumed run
with no epoch left closes the profiler all the same.

evaluate: the val sweep of a dataset's host val batches -> AP table.

Data parallelism: with a process group of p ranks (torchrun, or
parallel.launch.spawn) and train.mesh_shape over the axis 'data', every
rank draws the same global batch stream from train.seed, as the
reference's one host does, and keeps its rows (train.batch_size is the
global batch); the step keeps the global semantics (train_lib), so the
ranks hold one model. Rank 0 alone writes: checkpoints, the best-mAP
snapshot, train_meta.json, JSON lines, TensorBoard and the profiler
trace; every rank reads a resume. At k > 1 the stacked host feed keeps
each rank's rows on axis 1 of its [k, B, ...] blocks (device_prefetch),
and the device-synth block draws each step's global batch and cuts it.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from tpu3dsad_torch import train_lib
from tpu3dsad_torch.data import Batcher, get_dataset
from tpu3dsad_torch.data.device_pipeline import synthetic_detection_batch
from tpu3dsad_torch.data.packed import device_prefetch
from tpu3dsad_torch.eval.ap import APCalculator
from tpu3dsad_torch.eval.parse import (
    parse_groundtruths,
    parse_predictions,
    predictions_to_lists,
)
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.models.groupfree import GroupFree3D
from tpu3dsad_torch.models.ssd3d import SSD3D
from tpu3dsad_torch.parallel import collectives
from tpu3dsad_torch.parallel.mesh import make_mesh, shard_batch
from tpu3dsad_torch.utils import trace
from tpu3dsad_torch.utils.metrics import MetricsLogger


@dataclass
class TrainResult:
    """What run_detector leaves: the trained model and optimizer, the step
    it resumed from and the one it reached, one record per step run
    ({"step", "loss", "seconds", "wait"}: host wall time of the call that
    ran the step, which ends by reading its losses, and of it the time
    spent waiting for the batch, each divided by the call's k steps), and
    one per val sweep ({"epoch", "step", "seconds"} and evaluate's
    metrics)."""

    model: SizeAdaptiveDetector
    optimizer: train_lib.Optimizer
    start_step: int
    step: int
    history: list = field(default_factory=list)
    evals: list = field(default_factory=list)


# model.name -> why the port cannot train it
UNTRAINED = {
    "groupfree3d": (
        "model.name=groupfree3d has no training path in the port: "
        "Group-Free 3D's KPS sampling loss, focal objectness loss and "
        "per-stage box losses are not ported. It serves "
        "(tpu3dsad_torch.serving), evaluates (tpu3dsad_torch.eval_detector) "
        "and exports (serving.export_detector)"),
}


def build_detector(cfg, mean_sizes=None, *, device="cuda"):
    """The detector of cfg.model, weights drawn from cfg.train.seed: by
    model.name, 3DSSD ('ssd3d', models/ssd3d.py: its point features are
    model.ssd3d_point_features channels), Group-Free 3D ('groupfree3d',
    models/groupfree.py: xyz alone), else the size-adaptive detector,
    which with data.use_color takes the 3 colour channels as point
    features. The one factory of serving, evaluation and training."""
    if cfg.model.name == "ssd3d":
        return SSD3D(cfg.model, mean_sizes, device=device,
                     generator=torch.Generator().manual_seed(cfg.train.seed))
    if cfg.model.name == "groupfree3d":
        return GroupFree3D(
            cfg.model, mean_sizes, device=device,
            generator=torch.Generator().manual_seed(cfg.train.seed))
    return SizeAdaptiveDetector(
        cfg.model, mean_sizes, in_features=3 if cfg.data.use_color else 0,
        device=device,
        generator=torch.Generator().manual_seed(cfg.train.seed))


def run_detector(cfg, *, device="cuda") -> TrainResult:
    """Train the detector of `cfg` (a Config) on `device`, the card unless
    the caller asks for the CPU; resume from cfg.train.ckpt_dir if it holds
    a checkpoint. Group-Free 3D (model.name='groupfree3d') is refused: its
    losses are not ported."""
    if cfg.model.name in UNTRAINED:
        raise ValueError(UNTRAINED[cfg.model.name])
    if (cfg.data.name == "packed" and cfg.data.augment
            and not cfg.data.device_augment):
        raise ValueError(
            "packed scenes are canonical (packed with augment off): training "
            "with data.augment=true requires data.device_augment=true (the "
            "flip/rot/scale in the train step) — or set data.augment=false "
            "deliberately")
    # with device_augment the host loads canonical scenes and the train
    # step augments them on the card
    data_cfg = (replace(cfg, data=replace(cfg.data, augment=False))
                if cfg.data.device_augment else cfg)
    dataset = get_dataset(data_cfg, device=device)
    bs = cfg.train.batch_size
    steps_per_epoch, k = train_lib.round_steps_per_epoch(
        dataset.steps_per_epoch(bs), cfg.train.steps_per_call)
    train_lib.apply_runtime_config(cfg)
    mesh = make_mesh(cfg.train.mesh_shape, cfg.train.mesh_axes)
    lead = mesh.rank == 0

    model = build_detector(cfg, dataset.mean_sizes, device=device)
    optimizer = train_lib.make_optimizer(cfg.train, steps_per_epoch,
                                         model.parameters(),
                                         train_lib.data_axis(mesh))
    start_step = train_lib.restore_checkpoint(cfg.train.ckpt_dir, model,
                                              optimizer)
    if lead:
        n_params = sum(p.numel() for p in model.parameters())
        print(f"detector params: {n_params / 1e6:.2f}M", file=sys.stderr)
        if start_step:
            print(f"resumed from step {start_step}", file=sys.stderr)
        warning = train_lib.check_and_record_train_meta(
            cfg.train.ckpt_dir, steps_per_epoch, k, resumed=bool(start_step))
        if warning:
            print(warning, file=sys.stderr)

    eval_step = train_lib.make_detector_eval_step(model, cfg, mesh)

    def parse(end_points):
        return parse_predictions(end_points, model.mean_sizes,
                                 cfg.model.num_heading_bins, cfg.eval)

    step_gen = torch.Generator(device=device).manual_seed(cfg.train.seed + 1)
    aug_dataset = getattr(dataset, "source_dataset", None)
    batcher = make_batch = None
    synth_gens = ()
    if cfg.data.device_synth and cfg.data.name == "synthetic":
        data_gen = torch.Generator(device=device).manual_seed(
            cfg.train.seed + 1234)
        synth_gens = (data_gen,)

        def make_batch():
            # the global batch on every rank, cut to this rank's rows
            return shard_batch(synthetic_detection_batch(
                data_gen, bs, cfg.data.num_points, cfg.model.num_classes,
                cfg.data.max_boxes, vote_candidates=cfg.data.vote_candidates),
                mesh)

        # at k > 1 the block makes its batches itself
        batches = iter(make_batch, None) if k == 1 else None
    else:
        def host_batch(rng):
            if k == 1:
                return dataset.train_batch(rng, bs)
            # one draw of k x B scenes, stacked [k, B, ...]
            flat = dataset.train_batch(rng, k * bs)
            return {n: v.reshape((k, bs) + v.shape[1:])
                    for n, v in flat.items()}

        # host batches made ahead on a thread, copied ahead to the device
        batcher = Batcher(host_batch, seed=cfg.train.seed, prefetch=2)
        batches = device_prefetch(batcher, device, mesh=mesh, stacked=k > 1)
    if k > 1:
        train = train_lib.make_detector_train_block(
            model, optimizer, cfg, k, aug_dataset, synth_fn=make_batch,
            generators=synth_gens)
        if lead:
            print(f"train block: {train.mode} ({train.why})", file=sys.stderr)
    else:
        step = train_lib.make_detector_steps(model, optimizer, cfg,
                                             aug_dataset)

        def train(batch, generator, bn_momentum):
            return {n: v.reshape(1)
                    for n, v in step(batch, generator, bn_momentum).items()}

    logger = MetricsLogger(cfg.train.tb_dir, active=lead)
    result = TrainResult(model, optimizer, start_step, start_step)
    profiler = _start_profiler(cfg.train.profile_dir if lead else "", device)
    try:
        for epoch in range(start_step // steps_per_epoch,
                           cfg.train.num_epochs):
            _train_epoch(cfg, epoch, steps_per_epoch, k, batches, train,
                         step_gen, logger, result, lead)
            if profiler is not None:  # the first epoch run only
                _stop_profiler(profiler, cfg.train.profile_dir)
                profiler = None
            if (epoch + 1) % cfg.train.eval_every == 0:
                _evaluate_and_keep_best(cfg, epoch, dataset, eval_step,
                                        parse, logger, result, mesh)
    finally:
        if profiler is not None:  # no epoch left to run on a resume
            _stop_profiler(profiler, cfg.train.profile_dir)
        if batcher is not None:
            batches.close()
            batcher.close()
    logger.flush()
    return result


def _start_profiler(profile_dir: str, device):
    """A running torch.profiler over the CPU and, on the card, CUDA
    activity, with the program's tracer on, or None where profile_dir is
    empty."""
    if not profile_dir:
        return None
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    trace.enable()
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str) -> None:
    """Stop the profiler and the tracer; write the Chrome trace and the
    tracer's records (utils/trace.py) into profile_dir as trace.json and
    spans.jsonl."""
    profiler.stop()
    if torch.cuda.is_available():
        torch.cuda.synchronize()  # the spans' device ms are read next
    spans = trace.collect()
    trace.enable(False)
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    trace.write(os.path.join(profile_dir, "spans.jsonl"), spans)


def _train_epoch(cfg, epoch, steps_per_epoch, k, batches, train, step_gen,
                 logger, result, lead=True) -> None:
    """One epoch of train calls of k steps (train(batch, generator,
    bn_momentum) -> {metric: [k] tensor}), then its log line and
    checkpoint (written by the lead rank only)."""
    bs = cfg.train.batch_size
    bn_m = train_lib.bn_momentum_at(cfg.train, epoch)
    t0 = time.perf_counter()
    for _ in range(steps_per_epoch // k):
        t_call = time.perf_counter()
        batch = None if batches is None else next(batches)
        wait = time.perf_counter() - t_call
        metrics = train(batch, step_gen, bn_m)
        losses = metrics["loss"].tolist()  # waits for the call's kernels
        seconds = time.perf_counter() - t_call
        base = result.step
        result.step += k
        result.history.extend(
            {"step": base + j + 1, "loss": loss, "seconds": seconds / k,
             "wait": wait / k} for j, loss in enumerate(losses))
        rows = [j for j in range(k)
                if (base + j + 1) % cfg.train.log_every == 0]
        if rows:
            values = {n: v.tolist() for n, v in metrics.items()}
            for j in rows:
                logger.log(base + j + 1, {
                    "epoch": epoch,
                    **{n: round(v[j], 4) for n, v in values.items()}},
                    prefix="train/")
    dt = time.perf_counter() - t0
    if not lead:
        return
    print(json.dumps({"epoch": epoch, "epoch_time_s": round(dt, 2),
                      "scenes_per_sec": round(steps_per_epoch * bs / dt, 2)}),
          flush=True)
    if ((epoch + 1) % max(1, cfg.train.ckpt_every) == 0
            or epoch == cfg.train.num_epochs - 1):
        train_lib.save_checkpoint(cfg.train.ckpt_dir, result.model,
                                  result.optimizer, result.step)


def _evaluate_and_keep_best(cfg, epoch, dataset, eval_step, parse, logger,
                            result, mesh=None) -> None:
    """The val sweep: flat metrics logged under eval/, the per-class APs
    printed, and the model kept as the best snapshot where the first AP
    threshold's mAP improves. Every rank computes the same metrics; the
    lead rank alone prints and keeps the snapshot."""
    t0 = time.perf_counter()
    m = evaluate(cfg, result.model, dataset, eval_step, parse, mesh=mesh)
    result.evals.append({"epoch": epoch, "step": result.step,
                         "seconds": time.perf_counter() - t0, **m})
    flat = {k: v for k, v in m.items() if isinstance(v, (int, float))}
    logger.log(result.step, {"epoch": epoch, **flat}, prefix="eval/")
    if mesh is not None and mesh.rank != 0:
        return
    per_cls = {k: v for k, v in m.items() if isinstance(v, dict)}
    if per_cls:
        print(json.dumps({"epoch": epoch, **per_cls}), flush=True)
    lead = m.get(f"mAP@{cfg.eval.ap_iou_threshs[0]}")
    if lead is not None and train_lib.save_best_checkpoint(
            cfg.train.ckpt_dir, result.model, result.optimizer, result.step,
            lead):
        print(json.dumps({"epoch": epoch, "new_best_mAP": lead}), flush=True)


def evaluate(cfg, model, dataset, eval_step, parse, num_batches=None,
             mesh=None):
    """Val sweep -> AP table, on the model's device
    (tpu3dsad/train_detector.py:259-300).

    Each val batch goes to the device with its scene_mask, which marks the
    tail batch's padding scenes: the eval step's loss leaves them out and
    AP never scores them. parse(end_points) gives the parsed fields; their
    per-scene lists and the ground truth are scored on the host.

    With a mesh, every rank reads the same val batches and runs its rows
    of each on the 'data' axis (eval_step made with the mesh: its loss is
    the global batch's); the fixed-shape parsed fields are gathered over
    the data group in rank order, so every rank scores the global list in
    the reference's scene order and returns the same metrics.

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
        mine = {**batch_np, "scene_mask": scene_mask}
        if mesh is not None:
            mine = shard_batch(mine, mesh)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in mine.items()}
        end_points, metrics = eval_step(batch)
        if "loss" in metrics:  # 3DSSD's eval step has no loss
            losses.append(float(metrics["loss"]))
            loss_weights.append(float(scene_mask.mean()))
        parsed = {k: _gathered(v, mesh).cpu().numpy()
                  for k, v in parse(end_points).items()}
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


def _gathered(x: torch.Tensor, mesh) -> torch.Tensor:
    """x [b, ...], this rank's rows -> the data group's rows in rank order
    (x itself without a mesh)."""
    if mesh is None:
        return x
    g = collectives.all_gather(x, mesh.group("data"))
    return g.reshape(-1, *x.shape[1:])
