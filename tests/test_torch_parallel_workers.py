"""The code the ranks of tests/test_torch_parallel_{ops,dp,cp}.py run.

Each test file starts its ranks once (parallel.launch.spawn, gloo on the
CPU, one intra-op thread a rank) with one of the functions below, which
runs every scenario of that file on the ranks and returns their results
as numpy arrays. A spawned rank imports this module by name, so it
imports torch and the port only, never JAX or the JAX package; the test
files hold the JAX side and the comparisons. This file holds no test.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import shutil
from pathlib import Path

import numpy as np
import torch

from tpu3dsad_torch import ops, train_classifier, train_lib
from tpu3dsad_torch.config import Config, DataConfig, TrainConfig
from tpu3dsad_torch.data import get_dataset
from tpu3dsad_torch.data.packed import device_prefetch
from tpu3dsad_torch.eval.parse import parse_predictions
from tpu3dsad_torch.models.classifier import build_classifier
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.parallel import collectives, make_mesh, shard_batch
from tpu3dsad_torch.parallel import point_sharded as ps
from tpu3dsad_torch.train_detector import evaluate, run_detector
from tpu3dsad_torch.utils.bridge import load_flax_variables


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, (tuple, list)):
        return tuple(_np(v) for v in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


# ------------------------------------------------------ sharded ops (4)


def ops_ranks(rank: int, world: int, cases: dict) -> dict:
    """The sharded ops on a 1-D mesh of every rank ('points',) and on a
    2 x (world / 2) mesh ('data', 'points')."""
    mesh = make_mesh((-1,), ("points",))
    hybrid = make_mesh((2, -1), ("data", "points"))
    out = {"mesh": {"shape": mesh.shape, "index": mesh.axis_index("points"),
                    "group": mesh.group("points").ranks},
           "hybrid": {"shape": hybrid.shape,
                      "index": (hybrid.axis_index("data"),
                                hybrid.axis_index("points")),
                      "data": hybrid.group("data").ranks,
                      "points": hybrid.group("points").ranks}}
    c = cases["bq"]
    out["bq"] = _np(ps.sharded_ball_query(
        _t(c["xyz"]), _t(c["centers"]), c["r"], c["k"], mesh,
        mask=_t(c["mask"])))
    c = cases["bq_edge"]
    out["bq_edge"] = _np(ps.sharded_ball_query(
        _t(c["xyz"]), _t(c["centers"]), c["r"], c["k"], mesh))
    c = cases["fps"]
    before = collectives.calls
    out["fps"] = _np(ps.sharded_fps(_t(c["xyz"]), c["m"], mesh,
                                    mask=_t(c["mask"])))
    out["fps_calls"] = collectives.calls - before
    c = cases["knn"]
    out["knn"] = _np(ps.sharded_knn(_t(c["q"]), _t(c["s"]), c["k"], mesh,
                                    support_mask=_t(c["mask"])))
    c = cases["group"]
    out["group"] = _np(ps.sharded_group(_t(c["pts"]), _t(c["idx"]), mesh))
    c = cases["qg"]
    out["qg"] = _np(ps.sharded_query_and_group(
        _t(c["xyz"]), _t(c["xyz"][:, :c["m"]]), c["r"], c["k"], mesh,
        features=_t(c["feats"]), mask=_t(c["mask"]), normalize_xyz=True))
    feats = _t(c["feats"]).requires_grad_(True)
    grouped, _, gmask = ps.sharded_query_and_group(
        _t(c["xyz"]), _t(c["xyz"][:, :c["m"]]), c["r"], c["k"], mesh,
        features=feats, mask=_t(c["mask"]), normalize_xyz=True)
    (grouped.square() * gmask[..., None]).sum().backward()
    out["qg_grad"] = _np(feats.grad)
    c = cases["sa"]
    sa = ps.sharded_sa_stage(_t(c["xyz"]), _t(c["feats"]), c["m"], c["r"],
                             c["k"], mesh, mask=_t(c["mask"]))
    out["sa"] = _np(sa) + (_np(ops.masked_max(sa[1], sa[3], 2)),)
    c = cases["hybrid_sa"]
    out["hybrid_sa"] = _np(ps.sharded_sa_stage(
        _t(c["xyz"]), _t(c["feats"]), c["m"], c["r"], c["k"], hybrid,
        mask=_t(c["mask"]), batch_axis="data"))
    c = cases["hybrid_knn"]
    out["hybrid_knn"] = _np(ps.sharded_knn(
        _t(c["q"]), _t(c["s"]), c["k"], hybrid, support_mask=_t(c["mask"]),
        batch_axis="data"))
    g = mesh.group("points")
    mine = torch.tensor([rank * 1.5, float("inf"), -float("inf"),
                         float("nan"), 3.0e38])
    out["gather"] = {
        "float": _np(collectives.all_gather(mine, g)),
        "int": _np(collectives.all_gather(
            torch.tensor([rank, -7, 2 ** 30], dtype=torch.int32), g)),
        "bool": _np(collectives.all_gather(torch.tensor([rank % 2 == 0]),
                                           g)),
        "broadcast": _np(collectives.broadcast(
            torch.tensor([float(rank)]), g, src=world - 1)),
    }
    out["rows"] = _np(shard_batch({"a": torch.arange(8 * 3).reshape(8, 3),
                                   "k": torch.arange(2 * 8).reshape(2, 8)},
                                  hybrid)["a"])
    return out


# ---------------------------------------------- data parallelism (2)


def _detector(cfg, variables):
    model = SizeAdaptiveDetector(cfg.model, device="cpu")
    load_flax_variables(model, variables)
    return model


def _grads(model) -> dict:
    return {n: _np(p.grad) for n, p in model.named_parameters()
            if p.grad is not None}


def dp_step(cfg, variables, batch: dict, mesh, *, train_mode: bool) -> dict:
    """One detector step on this rank's rows of `batch` from the bridged
    `variables`: the step's global metrics, the gradients summed over the
    data group (train mode: make_detector_steps' own, after its update;
    eval mode: BatchNorm on its running statistics, no update) and the
    state after it."""
    model = _detector(cfg, variables)
    group = train_lib.data_axis(mesh)
    optimizer = train_lib.make_optimizer(cfg.train, 10, model.parameters(),
                                         group)
    rows = {k: _t(v) for k, v in shard_batch(batch, mesh).items()}
    if train_mode:
        step = train_lib.make_detector_steps(model, optimizer, cfg)
        metrics = step(rows, torch.Generator().manual_seed(1), 0.9)
    else:
        model.eval()
        with collectives.data_parallel(group):
            loss, metrics = train_lib.detector_loss(model, cfg, rows, 0.9)
            loss.backward()
        collectives.all_reduce_coalesced(
            [p.grad for p in model.parameters()], group)
        metrics = train_lib.reduce_metrics(metrics, group)
    return {"metrics": {k: float(v.detach()) for k, v in metrics.items()},
            "grads": _grads(model),
            "state": _np(dict(model.state_dict()))}


def dp_sweep(cfg, variables, mesh) -> dict:
    dataset = get_dataset(cfg, device="cpu")
    model = _detector(cfg, variables)
    eval_step = train_lib.make_detector_eval_step(model, cfg, mesh)

    def parse(end_points):
        return parse_predictions(end_points, model.mean_sizes,
                                 cfg.model.num_heading_bins, cfg.eval)

    return evaluate(cfg, model, dataset, eval_step, parse, num_batches=2,
                    mesh=mesh)


def dp_forward(cfg, variables, points, mask, mesh) -> dict:
    """This rank's rows of an eval-mode forward (the density sampler)."""
    model = _detector(cfg, variables)
    rows = shard_batch({"p": _t(points), "m": _t(mask)}, mesh)
    with torch.no_grad():
        ep = model(rows["p"], mask=rows["m"])
    return _np({k: ep[k] for k in ("proposal_inds", "proposal_xyz")})


def dp_classifier(cfg, batch: dict, mesh) -> dict:
    """One classifier step (dropout on) on this rank's rows."""
    model = build_classifier(cfg, cfg.model.num_classes, device="cpu")
    optimizer = train_lib.make_optimizer(cfg.train, 10, model.parameters(),
                                         train_lib.data_axis(mesh))
    rows = {k: _t(v) for k, v in shard_batch(batch, mesh).items()}
    metrics = train_lib.classifier_train_step(
        model, optimizer, rows, torch.Generator().manual_seed(5), 0.9)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _grads(model), "state": _np(dict(model.state_dict()))}


def dp_run(cfg) -> dict:
    """run_detector on the CPU: per-step losses, sweeps, final state, the
    steps it resumed from and reached, the optimizer's count, the JSON
    lines it printed and its lines on stderr."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = run_detector(cfg, device="cpu")
    return {"losses": [h["loss"] for h in result.history],
            "steps": [h["step"] for h in result.history],
            "start_step": result.start_step, "step": result.step,
            "count": int(result.optimizer.count),
            "evals": [{k: v for k, v in e.items() if k != "seconds"}
                      for e in result.evals],
            "state": _np(dict(result.model.state_dict())),
            "rows": [json.loads(line) for line in out.getvalue().splitlines()
                     if line.startswith("{")],
            "stderr": err.getvalue().splitlines()}


def dp_block(cfg, variables, stacked: dict, mesh, bn_m: float) -> dict:
    """A k-step block (k = the stacked batches' leading axis) on this
    rank's rows of the stacked host batches (axis 1, as device_prefetch
    keeps them), from the bridged `variables`; and the same k steps one at
    a time from the same state and generator seed, both at the BatchNorm
    momentum bn_m (a float that fp32 holds exactly, as
    train_lib.bn_momentum_at gives it, so that the block's 0-d tensor of
    it is the same number). Each: the [k] metrics, the state and the
    optimizer's count; the block's mode."""
    group = train_lib.data_axis(mesh)
    (rows,) = device_prefetch(iter([stacked]), "cpu", mesh=mesh,
                              stacked=True)
    k = len(rows["points"])
    out = {}
    for blocked in (True, False):
        model = _detector(cfg, variables)
        optimizer = train_lib.make_optimizer(cfg.train, 10,
                                             model.parameters(), group)
        gen = torch.Generator().manual_seed(7)
        if blocked:
            block = train_lib.make_detector_train_block(model, optimizer,
                                                        cfg, k)
            metrics = block(rows, gen, bn_m)
            out["mode"] = block.mode
        else:
            step = train_lib.make_detector_steps(model, optimizer, cfg)
            each = [step({n: v[i] for n, v in rows.items()}, gen, bn_m)
                    for i in range(k)]
            metrics = {n: torch.stack([m[n] for m in each])
                       for n in each[0]}
        out["block" if blocked else "steps"] = {
            "metrics": _np(metrics), "count": int(optimizer.count),
            "state": _np(dict(model.state_dict()))}
    return out


def dp_classifier_runs(cfg) -> dict:
    """run_classifier at cfg's train.steps_per_call and at 1, each in its
    own checkpoint directory, with 4 synthetic steps an epoch and one val
    batch: per-step metrics, final state, the files written."""
    kept = (train_classifier.SYNTHETIC_STEPS_PER_EPOCH,
            train_classifier.SYNTHETIC_VAL_BATCHES)
    train_classifier.SYNTHETIC_STEPS_PER_EPOCH = 4
    train_classifier.SYNTHETIC_VAL_BATCHES = 1
    out = {}
    try:
        for k in (cfg.train.steps_per_call, 1):
            run = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, steps_per_call=k,
                ckpt_dir=f"{cfg.train.ckpt_dir}_{k}"))
            with contextlib.redirect_stdout(io.StringIO()):
                result = train_classifier.run_classifier(run, device="cpu")
            torch.distributed.barrier()  # rank 0 has written
            out[k] = {"history": [{n: v for n, v in h.items()
                                   if n != "seconds"}
                                  for h in result.history],
                      "state": _np(dict(result.model.state_dict())),
                      "files": sorted(p.name for p in
                                      Path(run.train.ckpt_dir).iterdir())}
    finally:
        (train_classifier.SYNTHETIC_STEPS_PER_EPOCH,
         train_classifier.SYNTHETIC_VAL_BATCHES) = kept
    return out


def dp_k_runs(rank: int, cfg, host_cfg) -> dict:
    """run_detector at train.steps_per_call = k on the data group: the
    device-synth run `cfg`; the same config again on its directory (a
    resume with nothing left to run); a resume from its first epoch's
    checkpoint, which rank 0 copies into a fresh directory; the host-fed
    run `host_cfg` (stacked [k, B, ...] blocks, each rank's rows on axis
    1); and both runs at k = 1 in directories of their own. The ranks
    wait for each other between runs, so that no rank reads a checkpoint
    before rank 0 has written it."""
    ckpt = Path(cfg.train.ckpt_dir)
    resume = ckpt.parent / (ckpt.name + "_resume")
    out = {"run": dp_run(cfg)}
    torch.distributed.barrier()
    out["again"] = dp_run(cfg)
    if rank == 0:
        first = out["run"]["step"] // cfg.train.num_epochs
        resume.mkdir()
        shutil.copy(ckpt / f"ckpt_{first}.pt", resume)
    torch.distributed.barrier()
    out["resume"] = dp_run(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ckpt_dir=str(resume))))
    out["host"] = dp_run(host_cfg)
    for name, run in (("run_k1", cfg), ("host_k1", host_cfg)):
        out[name] = dp_run(dataclasses.replace(run, train=dataclasses.replace(
            run.train, steps_per_call=1, ckpt_dir=run.train.ckpt_dir + "_1")))
    return out


def dp_ranks(rank: int, world: int, case: dict) -> dict:
    """Every data-parallel scenario on a ('data',) mesh of every rank."""
    mesh = make_mesh((-1,), ("data",))
    out = {
        "step_train": dp_step(case["cfg"], case["variables"], case["batch"],
                              mesh, train_mode=True),
        "step_eval": dp_step(case["cfg"], case["variables"], case["batch"],
                             mesh, train_mode=False),
        "sweep": dp_sweep(case["sweep_cfg"], case["variables"], mesh),
        "density": dp_forward(case["density_cfg"], case["density_vars"],
                              case["batch"]["points"],
                              case["batch"]["point_mask"], mesh),
        "classifier": dp_classifier(case["cls_cfg"], case["cls_batch"],
                                    mesh),
        "prefetch": [_np(b) for b in device_prefetch(
            iter(case["plain"]), "cpu", mesh=mesh)],
        "prefetch_stacked": [_np(b) for b in device_prefetch(
            iter(case["stacked"]), "cpu", mesh=mesh, stacked=True)],
        "run": dp_run(case["run_cfg"]),
        "block": dp_block(case["cfg"], case["variables"], case["blocks"],
                          mesh, case["block_bn_m"]),
        "classifier_runs": dp_classifier_runs(case["cls_run_cfg"]),
    }
    torch.distributed.barrier()
    out["k"] = dp_k_runs(rank, case["k_cfg"], case["k_host_cfg"])
    return out


def tiny_config(ckpt_dir: str = "ckpt", **train) -> Config:
    """The synthetic run of the data-parallel tests (model set by the
    caller)."""
    return Config(data=DataConfig(name="synthetic", device_synth=True,
                                  num_points=256, max_boxes=8),
                  train=TrainConfig(batch_size=16, num_epochs=1,
                                    eval_every=1, log_every=2,
                                    ckpt_dir=ckpt_dir, **train))


# ------------------------------------------- context parallelism (2)


def cp_ranks(rank: int, world: int, case: dict) -> dict:
    """SizeAdaptiveDetector at cfg.model.cp_stages over a ('points',)
    mesh of every rank, eval mode, from bridged weights."""
    mesh = make_mesh((-1,), ("points",))
    model = _detector(case["cfg"], case["variables"])
    before = collectives.calls
    with torch.no_grad():
        ep = model(_t(case["points"]), mask=_t(case["mask"]), cp_mesh=mesh)
    return {"end_points": _np({k: ep[k] for k in case["keys"]}),
            "collectives": collectives.calls - before}
