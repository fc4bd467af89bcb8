"""Classifier training and evaluation, config #1 (the classifier branches
of the reference's train.py:43-148 and eval.py:74-131).

    python -m tpu3dsad_torch.train_classifier preset=classifier \\
        [data.name=modelnet data.root=DIR] [key=value ...]

run_classifier: train steps on one device, on batches from
data.name=modelnet (data/modelnet.py) or, for any other name, the
synthetic classification_batch (100 steps an epoch), made on the host
one a step and copied to the device. It prints the reference's JSON
lines: {"step", "epoch", "loss", "acc"} every `log_every` steps,
{"epoch", "epoch_time_s", "clouds_per_sec"} after each epoch, and
{"step", "eval/epoch", "eval/val_acc", "eval/val_loss", "eval/n_scenes"}
every `eval_every` epochs and after the last; it checkpoints every
`ckpt_every` epochs and after the last, and resumes from the newest
checkpoint. The reference's classifier path has no k-step block: it runs
one step a call whatever train.steps_per_call says, on any mesh, and so
does this one. With a process group and train.mesh_shape over the axis
'data' (data parallelism, train_lib), every rank draws the same global
batches and keeps its rows; the val sweep runs whole on every rank, as the
reference's runs unsharded; rank 0 alone prints and checkpoints.

run_eval_classifier: the val accuracy of the newest checkpoint (or the
best snapshot with eval.use_best), printed as {"ckpt_step", "val_acc",
"val_loss"}; eval_detector.main sends model.name=classifier here.

Both run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu3dsad_torch import train_lib
from tpu3dsad_torch.config import describe, parse_cli
from tpu3dsad_torch.data.synthetic import classification_batch
from tpu3dsad_torch.models.classifier import (
    PointNet2Classifier,
    build_classifier,
)
from tpu3dsad_torch.parallel.mesh import make_mesh, shard_batch

SYNTHETIC_STEPS_PER_EPOCH = 100  # train.py:63
SYNTHETIC_VAL_BATCHES = 8  # fresh clouds stand in for a val split


@dataclass
class ClassifierResult:
    """What run_classifier leaves: the trained model and optimizer, the
    step it resumed from and the one it reached, one record per step run
    ({"step", "loss", "acc", "seconds"}: host wall time of the step, which
    ends by reading its loss and accuracy), and one per val sweep
    ({"epoch", "step", "seconds"} and evaluate_classifier's metrics)."""

    model: PointNet2Classifier
    optimizer: train_lib.Optimizer
    start_step: int
    step: int
    history: list = field(default_factory=list)
    evals: list = field(default_factory=list)


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def evaluate_classifier(model, batches, device) -> dict:
    """{"val_acc", "val_loss", "n_scenes"} over numpy `batches`, each
    batch weighted by its valid items (scene_mask)."""
    tot_acc = tot_loss = tot_n = 0.0
    for vb in batches:
        m = train_lib.classifier_eval_step(model, to_device(vb, device))
        n = float(m["n_valid"])
        tot_acc += float(m["acc"]) * n
        tot_loss += float(m["loss"]) * n
        tot_n += n
    return {"val_acc": tot_acc / max(tot_n, 1.0),
            "val_loss": tot_loss / max(tot_n, 1.0), "n_scenes": int(tot_n)}


def run_classifier(cfg, *, device="cuda") -> ClassifierResult:
    """Train the classifier of `cfg` (a Config) on `device`, the card
    unless the caller asks for the CPU; resume from cfg.train.ckpt_dir if
    it holds a checkpoint."""
    train_lib.apply_runtime_config(cfg)
    mesh = make_mesh(cfg.train.mesh_shape, cfg.train.mesh_axes)
    lead = mesh.rank == 0
    bs = cfg.train.batch_size
    rng_np = np.random.default_rng(cfg.train.seed)
    if cfg.data.name == "modelnet":
        from tpu3dsad_torch.data.modelnet import ModelNetClassificationDataset

        ds = ModelNetClassificationDataset(cfg)
        steps_per_epoch = ds.steps_per_epoch(bs)
        num_classes = ds.num_classes

        def make_batch():
            return ds.train_batch(rng_np, bs)

        def val_batches():
            return ds.val_batches(rng_np, bs)
    else:
        steps_per_epoch = SYNTHETIC_STEPS_PER_EPOCH
        num_classes = cfg.model.num_classes

        def make_batch():
            return classification_batch(rng_np, bs, cfg.data.num_points,
                                        num_classes)

        def val_batches():
            return (make_batch() for _ in range(SYNTHETIC_VAL_BATCHES))

    model = build_classifier(cfg, num_classes, device=device)
    # the reference draws an example batch to initialise its model
    # (train.py:69), on a resume too; drawing it keeps the stream the same
    make_batch()
    optimizer = train_lib.make_optimizer(cfg.train, steps_per_epoch,
                                         model.parameters(),
                                         train_lib.data_axis(mesh))
    start_step = train_lib.restore_checkpoint(cfg.train.ckpt_dir, model,
                                              optimizer)
    if start_step and lead:
        print(f"resumed from step {start_step}", file=sys.stderr)
    gen = torch.Generator(device=device).manual_seed(cfg.train.seed + 1)
    result = ClassifierResult(model, optimizer, start_step, start_step)
    last = cfg.train.num_epochs - 1
    for epoch in range(start_step // steps_per_epoch, cfg.train.num_epochs):
        bn_m = train_lib.bn_momentum_at(cfg.train, epoch)
        t0 = time.perf_counter()
        for _ in range(steps_per_epoch):
            t_step = time.perf_counter()
            batch = to_device(shard_batch(make_batch(), mesh), device)
            metrics = train_lib.classifier_train_step(model, optimizer,
                                                      batch, gen, bn_m)
            m = {k: float(v) for k, v in metrics.items()}  # waits
            result.step += 1
            result.history.append({"step": result.step, **m,
                                   "seconds": time.perf_counter() - t_step})
            if lead and result.step % cfg.train.log_every == 0:
                print(json.dumps({"step": result.step, "epoch": epoch, **m}),
                      flush=True)
        dt = time.perf_counter() - t0
        if lead:
            print(json.dumps({
                "epoch": epoch, "epoch_time_s": round(dt, 2),
                "clouds_per_sec": round(steps_per_epoch * bs / dt, 2)}),
                flush=True)
        if (epoch + 1) % cfg.train.eval_every == 0 or epoch == last:
            t0 = time.perf_counter()
            m = evaluate_classifier(model, val_batches(), device)
            result.evals.append({"epoch": epoch, "step": result.step,
                                 "seconds": time.perf_counter() - t0, **m})
            if lead:
                print(json.dumps({
                    "step": result.step, "eval/epoch": epoch,
                    "eval/val_acc": round(m["val_acc"], 4),
                    "eval/val_loss": round(m["val_loss"], 4),
                    "eval/n_scenes": m["n_scenes"]}), flush=True)
        if lead and ((epoch + 1) % max(1, cfg.train.ckpt_every) == 0
                     or epoch == last):
            train_lib.save_checkpoint(cfg.train.ckpt_dir, model, optimizer,
                                      result.step)
    return result


def run_eval_classifier(cfg, *, device="cuda") -> dict:
    """Evaluate the newest checkpoint under cfg.train.ckpt_dir (or with
    eval.use_best the best snapshot) on the val split of data.modelnet, or
    on 4 synthetic batches from default_rng(999); random weights, with a
    warning on stderr, where there is no checkpoint."""
    train_lib.apply_runtime_config(cfg)
    rng = np.random.default_rng(999)
    if cfg.data.name == "modelnet":
        from tpu3dsad_torch.data.modelnet import ModelNetClassificationDataset

        ds = ModelNetClassificationDataset(cfg)
        num_classes = ds.num_classes
        batches = list(ds.val_batches(rng, cfg.train.batch_size))
        if not batches:
            raise SystemExit("no val items found under data.root")
    else:
        num_classes = cfg.model.num_classes
        batches = [classification_batch(rng, cfg.train.batch_size,
                                        cfg.data.num_points, num_classes)
                   for _ in range(4)]
    model = build_classifier(cfg, num_classes, device=device)
    step = train_lib.restore_checkpoint(cfg.train.ckpt_dir, model, None,
                                        for_eval=True,
                                        use_best=cfg.eval.use_best)
    if step == 0:
        print("WARNING: no checkpoint found — evaluating random weights",
              file=sys.stderr)
    m = evaluate_classifier(model, batches, device)
    out = {"ckpt_step": step, "val_acc": round(m["val_acc"], 4),
           "val_loss": round(m["val_loss"], 4)}
    print(json.dumps(out), flush=True)
    return out


def main(argv) -> ClassifierResult:
    cfg = parse_cli(argv)
    if cfg.model.name != "classifier":
        raise SystemExit(f"model.name={cfg.model.name}: this entry point "
                         "trains the classifier (preset=classifier)")
    print(describe(cfg), file=sys.stderr)
    return run_classifier(cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
