"""Training library (tpu3dsad/train_lib.py): runtime precision, schedules,
the optimizer, the detector train step, checkpoints.

The optimizer follows optax's formulas, which differ from torch's helpers
in two places: the learning rate of update k (0-based) is the schedule at
k, stepped once k reaches an epoch boundary (optax's
piecewise_constant_schedule on the count of earlier updates), and the
global-norm clip scales by max_norm / norm with no epsilon
(optax.clip_by_global_norm; torch's clip_grad_norm_ adds 1e-6). Adam and
AdamW place eps as optax does, which is torch.optim's placement.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from tpu3dsad_torch.data.device_pipeline import (
    augment_batch,
    decode_compact_votes,
    resolve_aug,
)
from tpu3dsad_torch.losses import detection_loss


def apply_runtime_config(cfg) -> None:
    """Set the matmul precision a Config asks for, process-wide, both ways:
    train.bf16_matmul=True lets CUDA fp32 matrix products run as TF32 (the
    MLPs, the proposal blend, three_interpolate); False keeps full fp32.
    Distances stay fp32 either way (ops/plain/knn.py pins them). The CPU
    is not affected."""
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.train.bf16_matmul)


def round_steps_per_epoch(steps_per_epoch: int,
                          steps_per_call: int) -> tuple[int, int]:
    """(rounded steps_per_epoch, effective k): epochs round DOWN to a
    multiple of k; k is clamped to steps_per_epoch."""
    k = max(1, min(steps_per_call, steps_per_epoch))
    if k > 1:
        steps_per_epoch = (steps_per_epoch // k) * k
    return steps_per_epoch, k


def check_and_record_train_meta(ckpt_dir: str, steps_per_epoch: int,
                                steps_per_call: int, *,
                                resumed: bool) -> str | None:
    """Record steps_per_epoch in <ckpt_dir>/train_meta.json; on resume,
    return a warning if the checkpointed run used another value (epoch
    boundaries and the lr / BN-momentum schedules would shift), keeping
    the original record."""
    path = Path(ckpt_dir).absolute() / "train_meta.json"
    if resumed and path.exists():
        prev = json.loads(path.read_text()).get("steps_per_epoch")
        if prev is not None and prev != steps_per_epoch:
            return (
                f"WARNING: resuming with steps_per_epoch={steps_per_epoch} "
                f"(train.steps_per_call={steps_per_call}) but the "
                f"checkpointed run used {prev} — epoch boundaries and the "
                "lr-decay/BN-momentum schedules will shift; use the original "
                "steps_per_call to preserve them")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"steps_per_epoch": steps_per_epoch,
                                "steps_per_call": steps_per_call}))
    return None


def lr_schedule(cfg, steps_per_epoch: int):
    """count -> learning rate: cfg.lr times every rate whose epoch
    boundary the count of earlier updates has reached."""
    boundaries = {int(e) * steps_per_epoch: float(r)
                  for e, r in zip(cfg.lr_decay_steps, cfg.lr_decay_rates)}

    def schedule(count: int) -> float:
        lr = cfg.lr
        for boundary, rate in sorted(boundaries.items()):
            if count >= boundary:
                lr *= rate
        return lr

    return schedule


def bn_momentum_at(cfg, epoch: int) -> float:
    """The flax running-average weight at `epoch`: 1 - the torch momentum,
    which starts at bn_momentum_init, halves every bn_decay_epochs and is
    floored at 1 - bn_momentum_max. fp32, as the reference computes it."""
    torch_m = max(cfg.bn_momentum_init * 0.5 ** (epoch // cfg.bn_decay_epochs),
                  1.0 - cfg.bn_momentum_max)
    return float(np.float32(1.0) - np.float32(torch_m))


class Optimizer:
    """Adam, or AdamW when weight_decay > 0, after an optional global-norm
    clip, on the lr schedule (optax.adam / adamw chained after
    clip_by_global_norm). `count` is the number of updates made."""

    def __init__(self, cfg, steps_per_epoch: int, params):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = lr_schedule(cfg, steps_per_epoch)
        self.clip = cfg.grad_clip
        self.count = 0
        kw = dict(lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8)
        if cfg.weight_decay > 0:
            self.inner = torch.optim.AdamW(
                self.params, weight_decay=cfg.weight_decay, **kw)
        else:
            self.inner = torch.optim.Adam(self.params, **kw)

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.clip > 0:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            keep = norm < self.clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.clip))
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(self.count)
        self.inner.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])


def make_optimizer(cfg, steps_per_epoch: int, params) -> Optimizer:
    """cfg: a TrainConfig."""
    return Optimizer(cfg, steps_per_epoch, params)


def detector_loss(model, cfg, batch: dict, bn_momentum: float):
    """Forward in the model's current mode, then detection_loss:
    (loss, metrics)."""
    end_points = model(batch["points"], batch.get("point_features"),
                       mask=batch["point_mask"], bn_momentum=bn_momentum)
    return detection_loss(
        end_points, batch, model.mean_sizes, cfg.model.num_heading_bins,
        tuple(cfg.model.cluster_radius_bank), near=cfg.model.assign_near,
        far=cfg.model.assign_far, center_norm=cfg.model.center_loss_norm)


def make_detector_steps(model, optimizer: Optimizer, cfg):
    """The detector's train step, closed over the model, the optimizer and
    the config: step(batch, generator, bn_momentum) -> metrics (detached
    0-d tensors). It decodes compact votes, augments on the card when
    data.device_augment and data.augment are set (draws from `generator`),
    runs forward, loss and backward in train mode, and updates the
    parameters and the BN running averages in place. The eval step waits
    with `evaluate` (ROADMAP A7)."""
    device_aug = cfg.data.device_augment and cfg.data.augment
    aug = resolve_aug(cfg.data, cfg.data.name) if device_aug else None

    def step(batch: dict, generator, bn_momentum: float) -> dict:
        batch = decode_compact_votes(batch, cfg.data.vote_candidates)
        if aug is not None:
            batch = augment_batch(batch, generator, **aug)
        model.train()
        optimizer.zero_grad()
        loss, metrics = detector_loss(model, cfg, batch, bn_momentum)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def _checkpoints(path: Path) -> dict[int, Path]:
    """step -> file of the checkpoints under `path`."""
    found = {}
    for f in path.glob("ckpt_*.pt"):
        tail = f.stem.split("_", 1)[1]
        if tail.isdigit():
            found[int(tail)] = f
    return found


def save_checkpoint(ckpt_dir: str, model, optimizer: Optimizer, step: int,
                    keep: int = 3) -> Path:
    """<ckpt_dir>/ckpt_<step>.pt holding the model's state_dict, the
    optimizer's and the step; only the newest `keep` are kept."""
    path = Path(ckpt_dir).absolute()
    path.mkdir(parents=True, exist_ok=True)
    target = path / f"ckpt_{step}.pt"
    tmp = path / f".ckpt_{step}.pt.tmp"
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "step": step}, tmp)
    os.replace(tmp, target)
    ckpts = _checkpoints(path)
    for old in sorted(ckpts)[:-keep]:
        ckpts[old].unlink()
    return target


def restore_checkpoint(ckpt_dir: str, model, optimizer: Optimizer) -> int:
    """Load the newest checkpoint under ckpt_dir into the model and the
    optimizer (auto-resume); returns its step, or 0 if there is none."""
    ckpts = _checkpoints(Path(ckpt_dir).absolute())
    if not ckpts:
        return 0
    device = next(model.parameters()).device
    state = torch.load(ckpts[max(ckpts)], map_location=device,
                       weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])
