"""Training library (tpu3dsad/train_lib.py): runtime knobs (grouping,
precision), schedules, the optimizer, the classifier's train and eval
steps, the detector train step and the k-step block (a CUDA graph on the
card without a data group, else eager steps), the detector eval step,
checkpoints.

The optimizer is optax's chain written in tensor ops, which differs from
torch's helpers in two places: the learning rate of update k (0-based) is
the schedule at k, stepped once k reaches an epoch boundary (optax's
piecewise_constant_schedule on the count of earlier updates), and the
global-norm clip scales by max_norm / norm with no epsilon
(optax.clip_by_global_norm; torch's clip_grad_norm_ adds 1e-6). Its
count, rate and moments stay on the device, so a captured step replays
the update.

Data parallelism (train.mesh_shape over the axis 'data', one process a
rank): the steps take this rank's rows of the global batch and keep the
reference's one-program semantics, so a world-p step is the world-1 step
of the same global batch up to fp32 summation order. Inside
collectives.data_parallel, BatchNorm takes its statistics over the data
group and the losses their denominators, so each rank's loss is its part
of the global loss; the optimizer sums the gradients over the group in one
flat buffer before the clip, so every rank takes the same update; draws
for the batch (augmentation, dropout) are made for the global batch and
cut to the rank's rows; the metrics are summed over the group. The model
is not wrapped in DistributedDataParallel, which averages gradients and
renames every state_dict key.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from tpu3dsad_torch import ops
from tpu3dsad_torch.data.augment import resolve_aug
from tpu3dsad_torch.data.device_pipeline import (
    augment_batch,
    decode_compact_votes,
)
from tpu3dsad_torch.losses import detection_loss, global_mean
from tpu3dsad_torch.parallel import collectives
from tpu3dsad_torch.utils import trace
from tpu3dsad_torch.utils.constants import device_constant


# the reference's ops tiers, which its command lines name
OPS_IMPLS = ("xla", "pallas")


def apply_runtime_config(cfg) -> None:
    """Set the process-wide knobs a Config carries, every one on every
    call, so a second Config in one process never inherits the first's:

      * grouping: ops_fast_grouping and ops_fast_mode (ops/__init__.py);
      * matmul precision: train.bf16_matmul=True lets CUDA fp32 matrix
        products run as TF32 (the MLPs, the proposal blend,
        three_interpolate); False keeps full fp32. Distances stay fp32
        either way (ops/plain/knn.py pins them). The CPU is not affected.

    ops_impl is checked ('xla' or 'pallas', else a ValueError, as the
    reference's ops.set_default_impl raises) and changes nothing. Unlike
    the reference, no environment variable takes part."""
    if cfg.ops_impl not in OPS_IMPLS:
        raise ValueError(
            f"ops_impl must be one of {OPS_IMPLS}, got {cfg.ops_impl!r}")
    ops.set_fast_grouping(bool(cfg.ops_fast_grouping))
    ops.set_fast_mode(cfg.ops_fast_mode)
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.train.bf16_matmul)


def data_axis(mesh):
    """The AxisGroup of the mesh's 'data' axis (None without a mesh)."""
    return None if mesh is None else mesh.group("data")


def reduce_metrics(metrics: dict, group) -> dict:
    """Each metric summed over the data group, in one collective (each
    rank's is its part of the global value)."""
    if group is None or group.size == 1:
        return metrics
    names = list(metrics)
    total = collectives.all_reduce_sum(
        torch.stack([metrics[n].detach().float() for n in names]), group)
    return dict(zip(names, total.unbind()))


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
    boundary the count of earlier updates has reached. `count` is an int,
    or a 0-d integer tensor: then the rate is a 0-d fp32 tensor on its
    device, picked there without a read to the host."""
    boundaries = sorted({int(e) * steps_per_epoch: float(r) for e, r in
                         zip(cfg.lr_decay_steps, cfg.lr_decay_rates)}.items())
    levels = [cfg.lr]  # the rate once the first i boundaries are reached
    for _, rate in boundaries:
        levels.append(levels[-1] * rate)
    starts = [b for b, _ in boundaries]

    def schedule(count):
        if isinstance(count, torch.Tensor):
            reached = (count >= device_constant(starts, count.device,
                                                np.int64)).sum()
            return torch.take(device_constant(levels, count.device), reached)
        return levels[sum(count >= b for b in starts)]

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
    clip_by_global_norm), in tensor ops on the parameters' device, so that
    a CUDA graph of a train step replays the update: `count` (the number
    of updates made) and the moments `mu`, `nu` are tensors updated in
    place, the rate is the schedule at `count` picked on the device, and
    nothing is read back to the host. Parameters without a gradient are
    left as they are. With a data group (an AxisGroup), the gradients are
    first summed over it in one flat buffer (every rank's backward leaves
    the same parameters without a gradient, since all run one graph)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, cfg, steps_per_epoch: int, params, group=None):
        self.params = [p for p in params if p.requires_grad]
        self.group = group
        self.schedule = lr_schedule(cfg, steps_per_epoch)
        self.clip = cfg.grad_clip
        self.weight_decay = cfg.weight_decay
        self.count = torch.zeros((), dtype=torch.int64,
                                 device=self.params[0].device)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        live = [i for i, p in enumerate(self.params) if p.grad is not None]
        params = [self.params[i] for i in live]
        mu = [self.mu[i] for i in live]
        nu = [self.nu[i] for i in live]
        grads = [p.grad for p in params]
        if collectives.active(self.group):
            with trace.span("train.allreduce"):
                collectives.all_reduce_coalesced(grads, self.group)
        if self.clip > 0:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            keep = norm < self.clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.clip))
        lr = self.schedule(self.count)
        self.count += 1
        t = self.count.float()
        torch._foreach_mul_(mu, self.B1)
        torch._foreach_add_(mu, grads, alpha=1 - self.B1)
        torch._foreach_mul_(nu, self.B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.B2)
        update = torch._foreach_div(mu, 1 - self.B1 ** t)
        denom = torch._foreach_div(nu, 1 - self.B2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        torch._foreach_div_(update, denom)
        if self.weight_decay > 0:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(params, update)

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a state into this optimizer's own tensors (a captured graph
        holds their addresses). Takes state_dict()'s layout, or that of
        torch.optim.Adam / AdamW ({"inner": its state_dict, "count": int}),
        which checkpoints hold from before the update was written in
        tensor ops."""
        if "inner" in state:
            inner = state["inner"]["state"]
            mu = [inner[i]["exp_avg"] if i in inner else torch.zeros_like(p)
                  for i, p in enumerate(self.params)]
            nu = [inner[i]["exp_avg_sq"] if i in inner
                  else torch.zeros_like(p) for i, p in enumerate(self.params)]
        else:
            mu, nu = state["mu"], state["nu"]
        if len(mu) != len(self.params) or any(
                m.shape != p.shape or v.shape != p.shape
                for m, v, p in zip(mu, nu, self.params)):
            raise ValueError("optimizer state does not match the parameters")
        for dst, src in zip(self.mu + self.nu, list(mu) + list(nu)):
            dst.copy_(src)
        self.count.copy_(torch.as_tensor(state["count"]))


def make_optimizer(cfg, steps_per_epoch: int, params,
                   group=None) -> Optimizer:
    """cfg: a TrainConfig; group: the data axis' AxisGroup, or None."""
    return Optimizer(cfg, steps_per_epoch, params, group)


def classifier_loss(model, batch: dict, bn_momentum,
                    generator: torch.Generator | None = None):
    """Forward in the model's current mode (dropout draws from
    `generator`), then cross entropy on the integer labels: (loss,
    {"loss", "acc"}) (tpu3dsad/train_lib.py:160-175)."""
    logits = model(batch["points"], mask=batch["mask"],
                   bn_momentum=bn_momentum, generator=generator)
    labels = batch["labels"].long()
    # means over the global batch (this rank's part under data_parallel)
    loss = global_mean(F.cross_entropy(logits, labels, reduction="none"))
    acc = global_mean((logits.argmax(-1) == labels).float())
    return loss, {"loss": loss, "acc": acc}


def classifier_train_step(model, optimizer: Optimizer, batch: dict,
                          generator: torch.Generator, bn_momentum) -> dict:
    """One classifier step in train mode: forward, loss, backward, and the
    update of the parameters and the BN running averages in place;
    returns the metrics as detached 0-d tensors. Under the optimizer's
    data group, `batch` holds this rank's rows of the global batch
    (module docstring)."""
    model.train()
    optimizer.zero_grad()
    with collectives.data_parallel(optimizer.group):
        loss, metrics = classifier_loss(model, batch, bn_momentum, generator)
        loss.backward()
    optimizer.step()
    return reduce_metrics({k: v.detach() for k, v in metrics.items()},
                          optimizer.group)


@torch.no_grad()
def classifier_eval_step(model, batch: dict) -> dict:
    """{"acc", "loss", "n_valid"} of a batch in eval mode, leaving out the
    items batch["scene_mask"] marks as tail padding (iter_val_batches)."""
    model.eval()
    logits = model(batch["points"], mask=batch["mask"])
    labels = batch["labels"].long()
    correct = (logits.argmax(-1) == labels).float()
    ce = F.cross_entropy(logits, labels, reduction="none")
    sm = batch.get("scene_mask")
    w = torch.ones_like(correct) if sm is None else sm.float()
    denom = w.sum().clamp_min(1.0)
    return {"acc": (correct * w).sum() / denom,
            "loss": (ce * w).sum() / denom, "n_valid": w.sum()}


def detector_loss(model, cfg, batch: dict, bn_momentum):
    """Forward in the model's current mode, then detection_loss:
    (loss, metrics)."""
    with trace.span("train.forward"):
        end_points = model(batch["points"], batch.get("point_features"),
                           mask=batch["point_mask"], bn_momentum=bn_momentum)
    with trace.span("train.loss"):
        return detection_loss(
            end_points, batch, model.mean_sizes, cfg.model.num_heading_bins,
            tuple(cfg.model.cluster_radius_bank), near=cfg.model.assign_near,
            far=cfg.model.assign_far, center_norm=cfg.model.center_loss_norm)


def make_detector_steps(model, optimizer: Optimizer, cfg,
                        aug_dataset: str | None = None):
    """The detector's train step, closed over the model, the optimizer and
    the config: step(batch, generator, bn_momentum) -> metrics (detached
    0-d tensors). It decodes compact votes, augments on the card when
    data.device_augment and data.augment are set (draws from `generator`;
    the recipe of `aug_dataset`, which defaults to cfg.data.name: a packed
    split passes its source dataset), runs forward, loss and backward in
    train mode, and updates the parameters and the BN running averages in
    place. bn_momentum is a float or a 0-d tensor on the model's device
    (nn/norm.py). Under the optimizer's data group `batch` holds this
    rank's rows of the global batch, the augmentation draws for the global
    batch, and the metrics are the global batch's (module docstring)."""
    device_aug = cfg.data.device_augment and cfg.data.augment
    aug = (resolve_aug(cfg.data, aug_dataset or cfg.data.name)
           if device_aug else None)
    group = optimizer.group

    def step(batch: dict, generator, bn_momentum) -> dict:
        with trace.span("train.step"):
            batch = decode_compact_votes(batch, cfg.data.vote_candidates)
            model.train()
            optimizer.zero_grad()
            with collectives.data_parallel(group):
                if aug is not None:
                    with trace.span("train.augment"):
                        batch = augment_batch(batch, generator, **aug)
                loss, metrics = detector_loss(model, cfg, batch, bn_momentum)
                with trace.span("train.backward"):
                    loss.backward()
            with trace.span("train.optimizer"):
                optimizer.step()
            return reduce_metrics(
                {k: v.detach() for k, v in metrics.items()}, group)

    return step


def block_mode(device: torch.device, group, k: int) -> tuple[str, str]:
    """A k-step block's mode on `device` with the data group `group` (an
    AxisGroup or None), and the reason: see DetectorTrainBlock."""
    if collectives.active(group):
        return "eager", f"data group of {group.size} ranks"
    if device.type != "cuda":
        return "eager", f"on the {device.type}"
    return "graph", f"one step captured, replayed {k} times a call"


class DetectorTrainBlock:
    """k train steps a call (train.steps_per_call; the reference's scanned
    block, tpu3dsad/train_lib.py:303-343): block(batches, generator,
    bn_momentum) -> {metric: [k] tensor}. `batches` carries a leading k
    axis on every entry (the stacked host feed), or is None where
    synth_fn() makes each step's batch on the device (data.device_synth);
    `generators` names the generators synth_fn draws from.

    Step i is make_detector_steps' step on slice i (or on synth_fn's
    batch), so a block is k sequential steps on the same batches and the
    same draws: parameters, BN running averages, optimizer state and
    metrics. The BN momentum is a 0-d tensor that each call fills.

    The mode (`mode`, with the reason in `why`) is fixed once, from the
    device and the optimizer's data group (block_mode), before any capture
    is tried:

      * "graph": on the card with no data group, or a group of one rank.
        The first call runs its k steps eagerly on a side stream, which
        warms the capture up; the second call captures one step into a
        CUDA graph (`graph`; it reads static input buffers, makes
        synth_fn's batch inside the graph, and has `generator` and
        `generators` registered, so each replay draws anew;
        `capture_seconds` is the host time the capture took), and every
        call from then on replays it k times, copying slice i into the
        static inputs before replay i. A capture or replay that fails
        raises: there is no eager fallback.
      * "eager": on the CPU, and with a data group of more than one rank
        on any device. Every call runs its k steps eagerly on the current
        stream. A DP step's collectives are not captured: gloo's go
        through the host, and a capture across NCCL ranks (one rank a
        card) needs several cards to show.

    Nothing inside a block reads a value back to the host, apart from
    what gloo's collectives do.

    Spans (utils/trace.py): "train.block" a call, with "train.capture" and
    "train.replay" in graph mode. A capture made with the tracer on keeps
    the captured step's spans as event nodes of the graph (`spans`, a
    trace.Captured); each call samples the device ms of the last call's
    last replay where it has finished, before it replays again."""

    def __init__(self, model, optimizer: Optimizer, cfg, k: int,
                 aug_dataset: str | None = None, synth_fn=None,
                 generators=()):
        self.step = make_detector_steps(model, optimizer, cfg, aug_dataset)
        self.k = k
        self.synth_fn = synth_fn
        self.generators = generators
        self.device = optimizer.count.device
        self.mode, self.why = block_mode(self.device, optimizer.group, k)
        self.bn_m = torch.zeros((), device=self.device)
        self.names: list[str] = []  # the metrics, in the first step's order
        self.stream = None  # the side stream of the warm-up and the capture
        self.graph = None
        self.capture_seconds = None
        self.inputs = self.outputs = None  # the graph's static buffers
        self.spans = None  # the trace.Captured of the graph's spans

    def __call__(self, batches, generator, bn_momentum) -> dict:
        with trace.span("train.block"):
            self.bn_m.fill_(bn_momentum)
            if self.mode == "eager":
                out = self._eager(batches, generator)
            elif self.stream is None:
                out = self._warm_up(batches, generator)
            else:
                if self.graph is None:
                    self._capture(batches, generator)
                else:  # the last call's replays, where they are done
                    self.spans.sample()
                out = self._replay(batches)
            return {n: out[:, j] for j, n in enumerate(self.names)}

    def _one(self, batch, generator) -> torch.Tensor:
        if self.synth_fn is not None:
            batch = self.synth_fn()
        metrics = self.step(batch, generator, self.bn_m)
        if not self.names:
            self.names.extend(metrics)
        return torch.stack([metrics[n] for n in self.names])

    def _eager(self, batches, generator) -> torch.Tensor:
        return torch.stack([
            self._one(None if batches is None else
                      {n: v[i] for n, v in batches.items()}, generator)
            for i in range(self.k)])

    def _warm_up(self, batches, generator) -> torch.Tensor:
        self.stream = torch.cuda.Stream(self.device)
        here = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            out = self._eager(batches, generator)
        here.wait_stream(self.stream)
        out.record_stream(here)
        return out

    def _capture(self, batches, generator) -> None:
        t0 = time.perf_counter()
        with trace.span("train.capture"):
            self.inputs = (None if batches is None else
                           {n: v[0].clone() for n, v in batches.items()})
            graph = torch.cuda.CUDAGraph()
            registered = []
            for gen in (generator, *self.generators):
                if all(gen is not g for g in registered):
                    graph.register_generator_state(gen)
                    registered.append(gen)
            with (trace.captured() as self.spans,
                  torch.cuda.graph(graph, stream=self.stream)):
                self.outputs = self._one(self.inputs, generator)
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0

    def _replay(self, batches) -> torch.Tensor:
        with trace.span("train.replay"):
            out = torch.empty(self.k, len(self.names), device=self.device)
            for i in range(self.k):
                if batches is not None:
                    for n, t in self.inputs.items():
                        t.copy_(batches[n][i], non_blocking=True)
                self.graph.replay()
                out[i].copy_(self.outputs)
        self.spans.replayed()
        return out


def make_detector_train_block(model, optimizer: Optimizer, cfg, k: int,
                              aug_dataset: str | None = None,
                              synth_fn=None,
                              generators=()) -> DetectorTrainBlock:
    """cfg: a Config; see DetectorTrainBlock."""
    return DetectorTrainBlock(model, optimizer, cfg, k, aug_dataset,
                              synth_fn, generators)


def make_detector_eval_step(model, cfg, mesh=None):
    """The detector's eval step: step(batch) -> (end_points, metrics). It
    decodes compact votes and runs the model in eval mode without
    gradients, then the detection loss, which leaves out the scenes that
    batch["scene_mask"] marks as padding (tpu3dsad/train_lib.py:271-285).
    With a mesh, `batch` holds this rank's rows: end_points are its rows',
    and the metrics are the global batch's. 3DSSD (model.name='ssd3d') and
    Group-Free 3D (model.name='groupfree3d') have no loss ported: their
    metrics are empty."""
    ms = model.mean_sizes
    group = data_axis(mesh)

    @torch.no_grad()
    def step(batch: dict):
        batch = decode_compact_votes(batch, cfg.data.vote_candidates)
        model.eval()
        end_points = model(batch["points"], batch.get("point_features"),
                           mask=batch["point_mask"])
        if cfg.model.name in ("ssd3d", "groupfree3d"):
            return end_points, {}
        with collectives.data_parallel(group):
            _, metrics = detection_loss(
                end_points, batch, ms, cfg.model.num_heading_bins,
                tuple(cfg.model.cluster_radius_bank),
                near=cfg.model.assign_near, far=cfg.model.assign_far,
                center_norm=cfg.model.center_loss_norm)
        return end_points, reduce_metrics(metrics, group)

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


def save_best_checkpoint(ckpt_dir: str, model, optimizer: Optimizer,
                         step: int, metric: float) -> bool:
    """Keep the best-metric snapshot beside the newest checkpoints: where
    `metric` (higher is better, the eval mAP) beats the one recorded in
    <ckpt_dir>/best.json, write <ckpt_dir>/best/ckpt_<step>.pt (only that
    one) and record {"metric", "step"}. Returns whether it wrote."""
    path = Path(ckpt_dir).absolute()
    record = path / "best.json"
    best = (json.loads(record.read_text())["metric"] if record.exists()
            else -float("inf"))
    if metric <= best:
        return False
    save_checkpoint(str(path / "best"), model, optimizer, step, keep=1)
    record.write_text(json.dumps({"metric": float(metric), "step": int(step)}))
    return True


def restore_checkpoint(ckpt_dir: str, model, optimizer: Optimizer | None,
                       *, for_eval: bool = False,
                       use_best: bool = False) -> int:
    """Load the newest checkpoint under ckpt_dir into the model and the
    optimizer (auto-resume, which never reads the best snapshot under
    best/); returns its step, or 0 if there is none. use_best=True loads
    the best-mAP snapshot (save_best_checkpoint) instead. for_eval=True
    loads the model alone: evaluation needs no optimizer."""
    path = Path(ckpt_dir).absolute()
    ckpts = _checkpoints(path / "best" if use_best else path)
    if not ckpts:
        return 0
    device = next(model.parameters()).device
    state = torch.load(ckpts[max(ckpts)], map_location=device,
                       weights_only=True)
    model.load_state_dict(state["model"])
    if not for_eval:
        optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])
