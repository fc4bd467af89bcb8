#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tpu3dsad_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

 1. device and build: the card's name and power limit (nvidia-smi), then
    nvcc builds the kernels from tpu3dsad_torch/csrc, one process per
    source, all at once, and where this run built them, each FPS kernel
    template's registers and spills from ptxas (a register tier must not
    spill); then one forward + backward of the config-#3 training step,
    recording the inputs of each of its kernel launches (and three_nn
    calls) for the phases below;
 2. the FPS kernel against its plain PyTorch version on the card, at the 5
    shapes of a served request and on the 5 recorded inputs of the
    training step and of the config-#4 eval batch, plus masked,
    all-masked and tied clouds, a grid repeated along N (ties across the
    CTAs' slices, B > 1), N not a multiple of C*T, slices wholly masked,
    forced plans that leave CTAs with no point (register and memory
    tiers), and B = 1 at N = 65536: picks must be exactly equal; beside
    each, the launch plan (cluster size, threads, points a thread, tier)
    and the us a round;
 3. the ball-query kernel (B3) against its plain version on the 7
    recorded inputs of a served request, of the training step and of the
    config-#4 eval batch (each launch compared 3 times: idx and cnt
    exactly equal), beside each its plan, time, the share of tiles its box
    test skips (computed in torch from the inputs) and its bound; then the
    7 request shapes on uniform clouds and the edge cases (ties, points at
    d2 == r2 and one ulp inside, centers at a tile box's faces +- r, masked
    tiles and an all-masked cloud, N % 32 != 0, K > N, empty and saturated
    balls, a spatially sorted cloud where most tiles skip) at every
    template instance of the scan, 3 times each;
 4. serving: SizeAdaptiveDetector(ModelConfig(num_classes=10)) with seeded
    random weights answers requests of 32 scenes x 20480 points through
    serving.build_inference_fn: one warm-up request, then the counted and
    timed ones. Outputs must be finite and of the right shapes, the launch
    counters must show 5 FPS and 7 ball-query launches per request and no
    scatter, and one request rerun with the plain ops on the same CUDA
    tensors must give the same keep mask;
 5. the scatter kernel (the gather/group backward, which sums each row
    in index order, whatever its length) on the 9 recorded launches of
    the training step (its own gradients and indices): bitwise equal to
    np.add.at in float32 on the host, the same bits in 3 launches, and
    exactly equal to the plain version on integer-valued gradients of
    each shape; then the same on heavy collisions (all of U on 8 rows),
    K zeros from masked centers, -1 / >= n indices and an odd width;
    beside each call, its longest row, its plan, and the kernel's,
    bound's and index_add_'s ms;
 6. training: train_detector.run_detector at config #3 (ModelConfig(), 18
    classes, 8 scenes x 40960 points, synthetic batches made on the card)
    for one epoch of 8 steps. Losses must be finite, the counters must show
    5 FPS, 7 ball-query and 9 scatter launches per step, parameters and BN
    statistics must have moved, the checkpoint must resume at step 8,
    the step's three_nn calls must pick the same indices under the
    training precision as in full fp32, and one step from one saved state
    and batch must give the same loss on the kernel path and the plain
    path and bitwise the same gradients (every kernel of the step gives
    its plain version's bits);
 7. the large-cloud FPS entry (B2, one thread-block cluster per cloud)
    against its plain version: on the cropped, bucketed config-#4 scene
    that phase 1's batch loading gave it (122880 raw points, 16384 picks;
    compared 3 times, since a missed memory fence shows as a rare wrong
    pick), N just above 65536, N = 786432 (the memory tier), a masked
    tail, an all-masked cloud and duplicated points (ties across the
    cluster's slices): picks exactly equal; beside each, the plan, the us
    a round, and the B1 entry's time on the same B = 1 input;
 8. the sorted ball query (B4: the Morton-code kernel, two torch sorts,
    then B3 on the permutations with the map-back in its epilogue) against
    the same glue around the plain version (sorted_views, plain, map_back),
    on the recorded SA1 inputs of configs #4, #5 and #3 and on masked junk
    and an all-masked cloud, 3 times each: idx and cnt exactly equal, the
    kernel's codes equal to the plain ones; counts equal to the exact
    tier's, the chosen set equal to it where a ball holds fewer than K
    points, and K distinct in-ball points where it is full; beside each,
    the time of the codes and sorts, of the scan, of the exact kernel on
    the same input, and the share of tiles skipped in either order;
 9. config #4 evaluation: eval_detector.run_eval (preset=outdoor,
    data.device_preproc=true, batch 8) over 12 val scenes of 122880 points
    with a checkpoint of seeded random weights, twice. First sweep: 12 B2
    launches (one per scene), 5 FPS and 7 ball-query launches per batch,
    2 batches (the second padded by scene_mask), finite metrics with
    0 <= mAP <= 1, the FPS caches written. Second sweep, with
    ops_fast_grouping=true ops_fast_mode=sorted: no B2 launch (cache
    hits), one sorted ball query per batch at SA1 beside 6 exact ones.
    One batch rerun with the plain ops gives the same keep in both modes.

Phase 1 also records the inputs of every kernel launch of one served
request and of one config-#4 eval batch (after loading the batch, which
runs B2 once per scene) for phases 2, 3 and 8.

Both sides of each comparison run on the same card; a differing pick is
printed, never hidden by a tolerance. Kernel times are CUDA-event means
over repeated launches; bound_ms is the least time the card could take for
the same work at NVIDIA's published H100 SXM peaks (3.35 TB/s; 67 TFLOP/s
fp32 outside the tensor cores). The line before the last is a JSON summary
of the kernels: times summed over one request, one training step, one
config-#4 eval batch (one scene for B2), and each path's own under
by_path; the last line names the device.
"""

from __future__ import annotations

import contextlib
import copy
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tpu3dsad_torch import eval_detector, ops, train_detector, train_lib
from tpu3dsad_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
    parse_cli,
)
from tpu3dsad_torch.data import get_dataset, kitti
from tpu3dsad_torch.data.device_pipeline import synthetic_detection_batch
from tpu3dsad_torch.data.synthetic_outdoor import write_dataset
from tpu3dsad_torch.eval.ap import APCalculator
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.ops import sorted as sorted_bq
from tpu3dsad_torch.ops.cuda import ball_query as cuda_bq
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda import fps as cuda_fps
from tpu3dsad_torch.ops.cuda import scatter as cuda_scatter
from tpu3dsad_torch.ops.plain import ball_query as plain_bq
from tpu3dsad_torch.ops.plain import furthest_point_sample as plain_fps
from tpu3dsad_torch.ops.plain import scatter_rows as plain_scatter
from tpu3dsad_torch.ops.plain.ball_query import radius_sq
from tpu3dsad_torch.serving import build_inference_fn
from tpu3dsad_torch.train_detector import build_detector, run_detector

B, N = 32, 20480  # BASELINE config #5, as bench.py runs it
REQUESTS = 5
# (name, N, npoint) of the 5 FPS calls of one request
FPS_SHAPES = [("sa1", N, 2048), ("sa2", 2048, 1024), ("sa3", 1024, 512),
              ("sa4", 512, 256), ("proposal", 1024, 256)]
# (name, N, M, radius, K) of the 7 ball-query calls of one request
BQ_SHAPES = [("sa1", N, 2048, 0.2, 64), ("sa2", 2048, 1024, 0.4, 32),
             ("sa3", 1024, 512, 0.8, 16), ("sa4", 512, 256, 1.2, 16),
             ("bank_0.15", 1024, 256, 0.15, 16),
             ("bank_0.3", 1024, 256, 0.3, 16),
             ("bank_0.6", 1024, 256, 0.6, 16)]
# config #3 training: 8 scenes x 40960 points, 8 steps (one epoch)
TRAIN_B, TRAIN_N, TRAIN_STEPS = 8, 40960, 8
# config #4 evaluation: KITTI-style scenes of 122880 raw points (BASELINE
# config #4 "~120k pts"), cropped and sampled to 16384 by B2, batch 8;
# 12 val scenes make two batches, the second half padding
EVAL_SCENES, EVAL_RAW_N, EVAL_B, EVAL_N = 12, 122880, 8, 16384
EVAL_ARGS = ["preset=outdoor", "data.device_preproc=true",
             f"train.batch_size={EVAL_B}"]
SORTED_ARGS = ["ops_fast_grouping=true", "ops_fast_mode=sorted"]
# NVIDIA's published H100 SXM peaks: HBM bytes/s, fp32 FLOP/s (no tensor
# cores)
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12


class Tally:
    """One kernel's numbers, summed over its shapes on each main path: the
    kernel's, the plain version's and the library call's ms, and the least
    time the card could take, per shape the larger of bytes / HBM_BPS and
    operations / FP32_FLOPS."""

    def __init__(self):
        self.paths = {}
        self.bound_by = {"bytes": 0.0, "operations": 0.0}
        self.max_abs_err = 0.0

    def add(self, path: str, nbytes: float, nops: float, ms: float,
            plain_ms: float, library_ms: float | None = None) -> float:
        """Add one shape's times; returns its bound in ms."""
        t_bytes, t_ops = nbytes / HBM_BPS * 1e3, nops / FP32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        self.bound_by["bytes" if t_bytes >= t_ops else "operations"] += bound
        p = self.paths.setdefault(path, {
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "library_ms": None if library_ms is None else 0.0})
        p["ms"] += ms
        p["plain_ms"] += plain_ms
        p["bound_ms"] += bound
        if library_ms is not None:
            p["library_ms"] += library_ms
        return bound

    def summary(self) -> dict:
        """Sums over the paths, and each path's own under by_path."""
        paths = self.paths.values()
        lib = [p["library_ms"] for p in paths if p["library_ms"] is not None]
        return {"max_abs_err": self.max_abs_err,
                **{k: sum(p[k] for p in paths)
                   for k in ("ms", "plain_ms", "bound_ms")},
                "bound_by": max(self.bound_by, key=self.bound_by.get),
                "library_ms": sum(lib) if lib else None,
                "by_path": self.paths}


def counts() -> dict:
    return {"fps": cuda_fps.launches, "fps_flat": cuda_fps.flat_launches,
            "ball_query": cuda_bq.launches, "sorted": sorted_bq.launches,
            "scatter": cuda_scatter.launches}


def reset_counts() -> None:
    cuda_fps.launches = cuda_fps.flat_launches = cuda_bq.launches = 0
    sorted_bq.launches = cuda_scatter.launches = 0


def launches(**given) -> dict:
    """A counts() dict with the given launches and 0 elsewhere."""
    return {k: given.pop(k, 0) for k in counts()} | given


def once_ms(fn):
    """(fn(), its ms by CUDA events), one call with no warm-up: for plain
    versions that take seconds."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over `iters` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def require_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Raise, showing the first differing entry, unless exactly equal.
    Returns the measured max absolute difference, 0 when it returns."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    diff = (got.long() - want.long()).abs()
    worst = diff.max().item() if diff.numel() else 0
    if worst != 0:
        at = tuple(torch.nonzero(diff)[0].tolist())
        raise AssertionError(
            f"{name}: kernel != plain at {at}: kernel {got[at].item()} plain "
            f"{want[at].item()} ({int((diff != 0).sum())} entries differ)")
    return worst


def cloud(gen, b, n, lo=-3.0, hi=3.0):
    return torch.empty(b, n, 3, device="cuda").uniform_(lo, hi, generator=gen)


def phase_device() -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    print(build.describe())
    for line in build.ptxas_log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print(f"  ptxas: {line.strip()}")
    if build.ptxas_log:
        report = fps_templates(build.ptxas_log)
        for points, (regs, spill) in sorted(report.items()):
            print(f"  fps_cluster_kernel<{points}>: {regs} registers, "
                  f"{spill} spill bytes")
        spilled = {p: s for p, (_, s) in report.items()
                   if s and p in cuda_fps.REGISTER_TIERS}
        if set(report) != {0, *cuda_fps.REGISTER_TIERS} or spilled:
            raise AssertionError(f"FPS templates {sorted(report)}, spill "
                                 f"bytes {spilled}")
    return card


def fps_templates(log: str) -> dict:
    """{points a thread: (registers, spill store + load bytes)} of each
    instance of the FPS kernel template in nvcc's -Xptxas=-v log."""
    report, points = {}, None
    for line in log.splitlines():
        if "entry function" in line:
            found = re.search(r"fps_cluster_kernelILi(\d+)E", line)
            points = int(found[1]) if found else None
            if points is not None:
                report[points] = [0, 0]
        elif points is not None:
            if found := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", line):
                report[points][1] = int(found[1]) + int(found[2])
            elif found := re.search(r"Used (\d+) registers", line):
                report[points][0] = int(found[1])
    return {p: tuple(v) for p, v in report.items()}


@contextlib.contextmanager
def recording():
    """Record the inputs of every FPS, ball-query and scatter launch and
    every three_nn call in the block, {kind: [(args, kwargs)]} with the
    tensors cloned; each call goes on to the kernel (or three_nn)."""
    calls = {"fps": [], "ball_query": [], "scatter": [], "three_nn": []}
    layouts = []  # whether each scatter's g came contiguous
    targets = [(cuda_fps, "furthest_point_sample", "fps"),
               (cuda_bq, "ball_query", "ball_query"),
               (cuda_scatter, "scatter_rows", "scatter"),
               (ops, "three_nn", "three_nn")]
    originals = [getattr(mod, attr) for mod, attr, _ in targets]

    def clone(a):
        return a.detach().clone() if torch.is_tensor(a) else a

    for (mod, attr, kind), fn in zip(targets, originals):
        def record(*args, _fn=fn, _kind=kind, **kw):
            if _kind == "scatter":
                layouts.append(args[0].is_contiguous())
            calls[_kind].append(([clone(a) for a in args],
                                 {k: clone(v) for k, v in kw.items()}))
            return _fn(*args, **kw)
        setattr(mod, attr, record)
    try:
        yield calls
    finally:
        if layouts:
            print(f"  scatter g contiguous at {sum(layouts)} of "
                  f"{len(layouts)} calls (the kernel reads strided rows "
                  "without a copy)")
        for (mod, attr, _), fn in zip(targets, originals):
            setattr(mod, attr, fn)


def capture_train_step(gen) -> dict:
    """The kernel inputs of one config-#3 training step, recorded call by
    call: forward, loss and backward of the config-#3 detector (weights
    from train.seed) on one synthetic batch of 8 x 40960 points."""
    print("== recording the kernel inputs of one config-#3 training step")
    cfg = train_config(tempfile.mkdtemp(prefix="tpu3dsad_torch_ckpt_"))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg, get_dataset(cfg).mean_sizes)
    batch = synthetic_detection_batch(gen, TRAIN_B, TRAIN_N, 18,
                                      vote_candidates=3)
    with recording() as calls:
        grads_of(model, cfg, model.state_dict(), batch,
                 train_lib.bn_momentum_at(cfg.train, 0))
    torch.backends.cuda.matmul.allow_tf32 = tf32  # serving runs as before
    found = {k: len(v) for k, v in calls.items()}
    print(f"  calls: {found}")
    if found != {"fps": 5, "ball_query": 7, "scatter": 9, "three_nn": 2}:
        raise AssertionError(f"one training step made {found} calls, not 5 "
                             "FPS, 7 ball query, 9 scatter and 2 three_nn")
    return calls


def capture_request() -> dict:
    """The kernel inputs of one served config-#5 request (the server of
    phase 4 on a request of its kind), recorded call by call."""
    print("== recording the kernel inputs of one config-#5 request")
    _, _, infer = build_server()
    (pts, mask), = make_requests(1, seed=REQUESTS + 1)
    with recording() as calls:
        infer(pts, mask)
    found = {k: len(v) for k, v in calls.items()}
    print(f"  calls: {found}")
    if (found["fps"], found["ball_query"], found["scatter"]) != (5, 7, 0):
        raise AssertionError(f"one request made {found} calls, not 5 FPS, "
                             "7 ball query and 0 scatter")
    # recorded under inference_mode: plain tensors for the phases below
    return {kind: [([a.clone() if torch.is_tensor(a) else a for a in args],
                    {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in kw.items()}) for args, kw in found_calls]
            for kind, found_calls in calls.items()}


def eval_config(root: str, ckpt_dir: str, *extra: str) -> Config:
    """Config #4 evaluation through the CLI's own parser: preset=outdoor,
    FPS on the card, batch 8, the scenes under `root`."""
    return parse_cli([*EVAL_ARGS, f"data.root={root}",
                      f"train.ckpt_dir={ckpt_dir}", *extra])


def prepare_outdoor(work: Path) -> dict:
    """Two copies of one synthetic outdoor dataset (12 val and 2 train
    scenes of 122880 points; each side writes its own FPS caches) and a
    checkpoint of the outdoor detector with seeded random weights, saved
    by train_lib.save_checkpoint."""
    roots = {}
    for name in ("capture", "sweep"):
        roots[name] = str(work / name)
        write_dataset(roots[name], scenes=2, val_scenes=EVAL_SCENES,
                      num_points=EVAL_RAW_N, seed=0)
    ckpt = str(work / "ckpt")
    cfg = eval_config(roots["sweep"], ckpt)
    model = build_detector(cfg, kitti.KITTI_MEAN_SIZES)
    optimizer = train_lib.make_optimizer(cfg.train, 1, model.parameters())
    train_lib.save_checkpoint(ckpt, model, optimizer, 1)
    return {**roots, "ckpt": ckpt}


def capture_eval_batch(outdoor: dict) -> tuple[dict, dict]:
    """The kernel inputs of one config-#4 eval batch: loading the first
    val batch (crop, B2 FPS per scene, pad), recorded apart, then the eval
    step of the checkpointed outdoor detector on it."""
    print("== recording the kernel inputs of one config-#4 eval batch")
    cfg = eval_config(outdoor["capture"], outdoor["ckpt"])
    train_lib.apply_runtime_config(cfg)
    dataset = get_dataset(cfg)
    with recording() as loads:
        batch = next(dataset.val_batches(np.random.default_rng(0), EVAL_B))
    model = build_detector(cfg, dataset.mean_sizes)
    train_lib.restore_checkpoint(cfg.train.ckpt_dir, model, None,
                                 for_eval=True)
    step = train_lib.make_detector_eval_step(model, cfg)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    with recording() as calls:
        step(batch)
    found = {k: len(v) for k, v in calls.items()}
    print(f"  loading: {len(loads['fps'])} FPS calls on one cloud each; "
          f"eval step calls: {found}")
    if found != {"fps": 5, "ball_query": 7, "scatter": 0, "three_nn": 2}:
        raise AssertionError(f"one eval batch made {found} calls, not 5 FPS, "
                             "7 ball query, 0 scatter and 2 three_nn")
    return loads, calls


def phase_fps(gen, train_calls, eval_calls) -> dict:
    print("== FPS kernel vs plain (exact picks)")
    tally = Tally()
    names = [name for name, _, _ in FPS_SHAPES]
    cases = [("serve", name, cloud(gen, B, n), m, None)
             for name, n, m in FPS_SHAPES]
    cases += [(path, name, args[0], args[1], kw.get("mask"))
              for path, calls in (("train", train_calls), ("eval4", eval_calls))
              for name, (args, kw) in zip(names, calls["fps"])]
    for path, name, xyz, m, mask in cases:
        b, n = xyz.shape[:2]
        got = cuda_fps.furthest_point_sample(xyz, m, mask=mask)
        used = cuda_fps.last_plan
        require_equal(f"fps {path} {name}", got,
                      plain_fps(xyz, m, mask=mask))
        k = cuda_ms(lambda: cuda_fps.furthest_point_sample(xyz, m, mask=mask),
                    10)
        p = cuda_ms(lambda: plain_fps(xyz, m, mask=mask), 2)
        # each of the m - 1 rounds: 3 sub, 3 mul, 2 add, min, compare per
        # point; xyz (and mask) read once, idx written once
        bound = tally.add(path, b * n * (12 + (mask is not None)) + b * m * 4,
                          10.0 * b * n * (m - 1), k, p)
        print(f"  {path} {name:9s} [{b},{n}]->{m}: kernel {k:.3f} ms "
              f"({k * 1e3 / (m - 1):.3f} us/round; {plan_text(used)})  plain "
              f"{p:.3f} ms  bound {bound:.3f} ms  equal")
    Plan = cuda_fps.Plan
    # masked tail, an all-masked cloud, exact distance ties on a grid (in
    # place, and a grid repeated along N so that ties straddle the slices of
    # the CTAs at B > 1), N not a multiple of C*T, slices wholly masked, and
    # B = 1 at N = 65536; forced plans put CTAs past N (no point at all) in
    # the register and the memory tier
    xyz = cloud(gen, 4, N)
    mask = torch.ones(4, N, dtype=torch.bool, device="cuda")
    mask[0, N // 3:] = False
    mask[1] = False
    mask[2, ::2] = False
    tied = torch.randint(-4, 5, (4, 4096, 3), device="cuda",
                         generator=gen).float()
    grid = torch.randint(-4, 5, (4, 1500, 3), device="cuda",
                         generator=gen).float().repeat(1, 20, 1).contiguous()
    holes = torch.ones(4, EVAL_N, dtype=torch.bool, device="cuda")
    holes[1, 2048:4096] = False  # slice 1 of 8 x 2048
    holes[2, EVAL_N - 2048:] = False  # the last slice
    holes[3, :2048] = False  # the first slice, index 0's
    small = cloud(gen, 2, 3000)
    cases = {"masked": (xyz, mask, 2048, None),
             "ties": (tied, None, 512, None),
             "ties across slices": (grid, None, 1024, None),
             "N=20001": (cloud(gen, 3, 20001), None, 2048, None),
             "masked slices": (cloud(gen, 4, EVAL_N), holes, 2048, None),
             "empty CTA": (small, None, 512, [Plan(4, 1024, 1)]),
             "empty CTAs": (small, None, 512, [Plan(8, 256, 2)]),
             "memory tier": (small, None, 512, [Plan(16, 32, 0)]),
             "memory tier, empty CTAs": (small[:, :40].contiguous(), None,
                                         40, [Plan(16, 32, 0)]),
             "B=1 N=65536": (cloud(gen, 1, 65536, -30.0, 30.0), None, 2048,
                             None)}
    for label, (x, mk, m, plans) in cases.items():
        got = cuda_fps.fps_batched(x, m, mk, plans)
        used = cuda_fps.last_plan
        require_equal(f"fps {label}", got, plain_fps(x, m, mask=mk))
        k = cuda_ms(lambda: cuda_fps.fps_batched(x, m, mk, plans), 3)
        print(f"  {label} [{x.shape[0]},{x.shape[1]}]->{m}: equal; {k:.3f} "
              f"ms ({k * 1e3 / (m - 1):.3f} us/round; {plan_text(used)})")
    return tally.summary()


def plan_text(plan) -> str:
    return (f"cluster {plan.cluster} x {plan.threads} threads, "
            f"{plan.tier}")


# the scan's template instances (centers a warp x loads), each at 4 warps
# a block, and a block of 3 warps: the edge cases run at every one
EDGE_PLANS = [cuda_bq.Plan(4, c, shared) for c in cuda_bq.CENTERS
              for shared in (False, True)] + [cuda_bq.Plan(3, 2, True)]
COMPARES = 3  # launches of each ball-query case compared with the plain


def check_bq(label, xyz, centers, r, k, mask, want, **kw):
    """COMPARES launches of the B3 kernel, each exactly equal to `want`
    (idx, cnt); returns the last."""
    for _ in range(COMPARES):
        got = cuda_bq.ball_query(xyz, centers, r, k, mask, **kw)
        require_equal(f"{label} idx", got[0], want[0])
        require_equal(f"{label} cnt", got[1], want[1])
    return got


def scan_work(xyz, centers, r, k, mask, idx, cnt, perm=None):
    """What this data needs of a scan, each center up to its K-th hit (the
    whole cloud where it has fewer), in the kernel's scan order (the Z
    order of the sorted tier where perm is given): (points an index-order
    scan tests, points in the 32-point tiles the conservative box test
    cannot skip, box tests). Computed in torch from the inputs and the
    output: tile boxes of the valid points, the separation test with the
    kernel's fp32 operations and threshold."""
    B, N, _ = xyz.shape
    tile = cuda_bq.TILE
    T = -(-N // tile)
    valid = (torch.ones(B, N, dtype=torch.bool, device=xyz.device)
             if mask is None else mask.bool())
    last = idx[..., -1].long()
    if perm is not None:
        xyz = torch.gather(xyz, 1, perm[..., None].expand(B, N, 3))
        valid = torch.gather(valid, 1, perm)
        rank = torch.empty_like(perm).scatter_(
            1, perm, torch.arange(N, device=xyz.device).expand(B, N))
        last = torch.gather(rank, 1, last)
    last = torch.where(cnt == k, last, N - 1)  # the last point scanned
    pts = torch.full((B, T * tile, 3), float("nan"), device=xyz.device)
    pts[:, :N] = torch.where(valid[..., None], xyz, float("nan"))
    pts = pts.view(B, T, tile, 3)
    lo = torch.where(pts.isnan(), float("inf"), pts).amin(2)[:, None]
    hi = torch.where(pts.isnan(), float("-inf"), pts).amax(2)[:, None]
    thr = cuda_bq.skip_radius_sq(radius_sq(r))
    kept = tests = 0
    tiles = torch.arange(T, device=xyz.device)
    for s in range(0, centers.shape[1], 256):
        c = centers[:, s:s + 256, None, :]
        sep = torch.maximum(lo - c, c - hi).clamp_min(0.0)
        sep2 = (sep[..., 0] * sep[..., 0] + sep[..., 1] * sep[..., 1]
                ) + sep[..., 2] * sep[..., 2]
        upto = tiles <= (last[:, s:s + 256, None] // tile)
        kept += ((sep2 <= thr) & upto).sum().item()
        tests += upto.sum().item()
    return (last + 1).sum().item(), tile * kept, tests


def bq_cost(b, n, m, k, mask, work) -> tuple[float, float]:
    """(bytes, operations) of a ball query on this data: xyz (and mask) and
    centers read once, idx and cnt written once; 9 operations a point an
    index-order scan tests, or, where the box test skips tiles, 9 a point
    of the tiles it keeps and 12 a box test, if fewer."""
    scanned, kept, tests = work
    nbytes = b * n * (12 + (mask is not None)) + b * m * 12 + b * m * (k + 1) * 4
    return nbytes, min(9.0 * scanned, 9.0 * kept + 12.0 * tests)


def skip_text(work) -> str:
    scanned, kept, tests = work
    return (f"tiles skipped {1 - kept / cuda_bq.TILE / max(tests, 1):.3f}, "
            f"points a center {scanned:.4g} in order / {kept:.4g} kept")


def bq_edge_cases(gen) -> dict:
    """label -> (xyz, centers, mask, r, K): the edge cases of the scan."""
    xyz = cloud(gen, 4, 4096, -0.5, 0.5)
    mask = torch.rand(4, 4096, device="cuda", generator=gen) < 0.7
    mask[3] = False
    centers = torch.cat([xyz[:, :200], cloud(gen, 4, 56, 5.0, 6.0)], 1)
    ties = torch.randint(-4, 5, (4, 4096, 3), device="cuda",
                         generator=gen).float()
    # r = 0.5: d2 == r2 = 0.25 at (0.5, 0, 0); one ulp inside at (0, -in, 0)
    inside = float(np.nextafter(np.float32(0.5), np.float32(0)))
    edge = cloud(gen, 2, 4096, 2.0, 3.0)
    edge[:, 0:3000:3] = torch.tensor([0.5, 0.0, 0.0], device="cuda")
    edge[:, 1:3000:3] = torch.tensor([0.0, -inside, 0.0], device="cuda")
    # z-sorted: tiles banded in z; centers at each tile's top +- r
    banded = cloud(gen, 2, 4096)
    banded[..., 2] = banded[..., 2].sort(1).values
    tops = banded[:, cuda_bq.TILE - 1::cuda_bq.TILE, 2]
    steps = torch.tensor([-1.0005, -0.9995, 0.0, 0.9995, 1.0005],
                         device="cuda")
    faces = torch.zeros(2, 640, 3, device="cuda")
    faces[..., 2] = (tops.repeat(1, 5) + 0.1 * steps.repeat_interleave(128))
    holes = torch.rand(4, 4096, device="cuda", generator=gen) < 0.8
    holes[0, 64:1024] = False  # whole tiles masked
    holes[1, ::64] = False
    holes[2] = False  # an all-masked cloud
    ordered = cloud(gen, 4, 8192)
    ordered = torch.gather(ordered, 1, ordered[..., :1].argsort(1).expand(
        4, 8192, 3)).contiguous()
    ragged = cloud(gen, 3, 4001, -0.5, 0.5)
    tail = torch.ones(3, 4001, dtype=torch.bool, device="cuda")
    tail[:, 3990:] = False
    return {
        "masked+empty": (xyz, centers, mask, 0.1, 32),
        "saturated": (xyz, centers, None, 0.3, 64),
        "K>N": (xyz[:, :40].contiguous(), centers, None, 0.4, 64),
        "ties": (ties, ties[:, :256].contiguous(), None, 1.5, 32),
        "d2 == r2, one ulp inside": (
            edge, torch.zeros(2, 64, 3, device="cuda"), None, 0.5, 64),
        "tile faces +- r": (banded, faces, None, 0.1, 32),
        "masked tiles, all-masked cloud": (xyz, centers, holes, 0.1, 32),
        "N=4001": (ragged, ragged[:, :300].contiguous(), tail, 0.1, 32),
        "sorted cloud": (ordered, ordered[:, ::8].contiguous(), None, 0.2,
                         64),
    }


def phase_ball_query(gen, serve_calls, train_calls, eval_calls) -> dict:
    print(f"== ball-query kernel (B3) vs plain (exact idx and cnt, "
          f"{COMPARES} launches each)")
    tally = Tally()
    names = [name for name, *_ in BQ_SHAPES]
    cases = [(path, name, *args, kw.get("mask"))
             for path, calls in (("serve", serve_calls), ("train", train_calls),
                                 ("eval4", eval_calls))
             for name, (args, kw) in zip(names, calls["ball_query"])]
    for path, name, xyz, centers, r, k, mask in cases:
        (b, n), m = xyz.shape[:2], centers.shape[1]
        want = plain_bq(xyz, centers, r, k, mask=mask)
        gi, gc = check_bq(f"ball_query {path} {name}", xyz, centers, r, k,
                          mask, want)
        used = cuda_bq.last_plan
        t = cuda_ms(lambda: cuda_bq.ball_query(xyz, centers, r, k, mask=mask),
                    10)
        p = cuda_ms(lambda: plain_bq(xyz, centers, r, k, mask=mask), 2)
        work = scan_work(xyz, centers, r, k, mask, gi, gc)
        bound = tally.add(path, *bq_cost(b, n, m, k, mask, work), t, p)
        per = tuple(w / (b * m) for w in work)
        print(f"  {path} {name:9s} N={n} M={m} r={r:g} K={k}: kernel {t:.3f}"
              f" ms ({used})  plain {p:.3f} ms  bound {bound:.3f} ms  equal; "
              f"{skip_text(per)}; mean cnt {gc.float().mean():.2f}")
    for name, n, m, r, k in BQ_SHAPES:  # uniform clouds, centers unordered
        xyz = cloud(gen, B, n)
        centers = xyz[:, :m].contiguous()
        check_bq(f"ball_query uniform {name}", xyz, centers, r, k, None,
                 plain_bq(xyz, centers, r, k))
    print(f"  the {len(BQ_SHAPES)} request shapes on uniform clouds: equal")
    for label, (x, c, mk, r, k) in bq_edge_cases(gen).items():
        want = plain_bq(x, c, r, k, mask=mk)
        for launch in EDGE_PLANS:
            check_bq(f"ball_query {label} ({launch})", x, c, r, k, mk, want,
                     launch=launch)
        work = scan_work(x, c, r, k, mk, *want)
        per = tuple(w / (x.shape[0] * c.shape[1]) for w in work)
        print(f"  {label}: equal at {len(EDGE_PLANS)} launch shapes (cnt min "
              f"{want[1].min().item()} max {want[1].max().item()}; "
              f"{skip_text(per)})")
    return tally.summary()


def build_server():
    """(cfg, model, infer): the config #5 detector with seeded random
    weights on the card, behind serving.build_inference_fn."""
    cfg = Config(model=ModelConfig(num_classes=10))
    model = SizeAdaptiveDetector(cfg.model,
                                 generator=torch.Generator().manual_seed(0))
    return cfg, model, build_inference_fn(cfg, model, model.mean_sizes)


def make_requests(count: int, seed: int = 0) -> list:
    """`count` (points [B,N,3], mask [B,N]) batches on the card, uniform in
    a 6 m cube; scene 1 of each is a quarter padding."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(count):
        pts = rng.uniform(-3, 3, (B, N, 3)).astype(np.float32)
        mask = np.ones((B, N), bool)
        mask[1, N * 3 // 4:] = False  # a partly padded scene
        batches.append((torch.from_numpy(pts).cuda(),
                        torch.from_numpy(mask).cuda()))
    torch.cuda.synchronize()
    return batches


def phase_serve(card: str) -> dict:
    print(f"== serving 1 warm-up + {REQUESTS} requests of {B} scenes x "
          f"{N} points")
    cfg, _, infer = build_server()
    warmup, *batches = make_requests(REQUESTS + 1, seed=0)
    t0 = time.perf_counter()
    infer(*warmup)
    torch.cuda.synchronize()
    print(f"  warm-up request (cuBLAS, allocator): "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms")

    reset_counts()
    times, outs = [], []
    for pts, mask in batches:
        t0 = time.perf_counter()
        out = infer(pts, mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    served = counts()
    print(f"  launches: {served}")
    if served != launches(fps=5 * REQUESTS, ball_query=7 * REQUESTS):
        raise AssertionError(f"launch counts {served} != 5, 7 and 0 per "
                             "request")

    P = cfg.model.num_proposals
    shapes = {"center": (B, P, 3), "size": (B, P, 3), "heading": (B, P),
              "sem_cls": (B, P), "obj_prob": (B, P), "keep": (B, P)}
    for out in outs:
        for key, shape in shapes.items():
            if tuple(out[key].shape) != shape:
                raise AssertionError(f"{key}: {tuple(out[key].shape)}")
            if out[key].is_floating_point() and not out[key].isfinite().all():
                raise AssertionError(f"{key}: non-finite values")
    kept = [int(o["keep"].sum()) for o in outs]
    print(f"  outputs finite, shapes ok; boxes kept per request: {kept}")

    with ops.use_impl("plain"):
        plain = infer(*batches[0])
    if counts() != served:
        raise AssertionError("the plain rerun launched a kernel")
    require_equal("keep (kernel path vs plain path)", outs[0]["keep"],
                  plain["keep"])
    require_equal("sem_cls (kernel path vs plain path)", outs[0]["sem_cls"],
                  plain["sem_cls"])
    dc = (outs[0]["center"] - plain["center"]).abs().max().item()
    print(f"  plain-ops rerun of request 0: keep and sem_cls identical, "
          f"center max |diff| {dc:.3g}")
    med = statistics.median(times)
    print(f"  per warm request: {[round(t * 1e3, 3) for t in times]} ms; "
          f"median {med * 1e3:.3f} ms = {B / med:.2f} scenes/s on {card}")
    return {"counts": served, "median_ms": med * 1e3}


def add_at(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The scatter on the host by np.add.at in float32, a sequential sum in
    index order: what the kernel must equal bit for bit."""
    B, _, C = g.shape
    g, idx = g.cpu().numpy(), idx.long().cpu().numpy()
    ok = (idx >= 0) & (idx < n)
    out = np.zeros((B * n, C), np.float32)
    np.add.at(out, (idx + np.arange(B)[:, None] * n)[ok], g[ok])
    return torch.from_numpy(out.reshape(B, n, C))


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> str | None:
    """Where two fp32 tensors differ in their bits, or None."""
    diff = a.view(torch.int32) != b.view(torch.int32)
    if not diff.any():
        return None
    at = tuple(torch.nonzero(diff)[0].tolist())
    return (f"at {at}: {a[at].item()!r} vs {b[at].item()!r} "
            f"({int(diff.sum())} entries differ)")


def longest_row(idx: torch.Tensor, n: int) -> int:
    """The most entries of one row of one cloud."""
    ok = (idx >= 0) & (idx < n)
    flat = (idx.long() + torch.arange(idx.shape[0], device=idx.device
                                      )[:, None] * n)[ok]
    return int(torch.bincount(flat, minlength=idx.shape[0] * n).max())


def check_scatter(name, g, idx, n, gen) -> dict:
    """The kernel on integer-valued gradients of g's shape equal to the
    plain version (exact in any order); on g itself the same bits in 3
    launches, and bitwise np.add.at on the host. Returns the longest row
    and max |kernel - plain| on g."""
    whole = torch.randint(-64, 65, g.shape, device="cuda",
                          generator=gen).float()
    got = cuda_scatter.scatter_rows(whole, idx, n)
    if (at := bits_differ(got, plain_scatter(whole, idx, n))) is not None:
        raise AssertionError(f"scatter {name}: kernel != plain on integer g "
                             f"{at}")
    outs = [cuda_scatter.scatter_rows(g, idx, n) for _ in range(3)]
    for again in outs[1:]:
        if (at := bits_differ(again, outs[0])) is not None:
            raise AssertionError(f"scatter {name}: launches differ {at}")
    if (at := bits_differ(outs[0].cpu(), add_at(g, idx, n))) is not None:
        raise AssertionError(f"scatter {name}: kernel != np.add.at {at}")
    err = (outs[0] - plain_scatter(g, idx, n)).abs().max().item()
    return {"longest": longest_row(idx, n), "vs_plain": err}


def phase_scatter(gen, train_calls) -> dict:
    print("== scatter kernel at the training step's launches: bitwise "
          "np.add.at and the same bits in 3 launches (integer g: equal to "
          "plain)")
    tally = Tally()
    for args, _ in train_calls["scatter"]:
        g, idx, n = args
        B, U, C = g.shape
        name = f"n={n} U={U} C={C}"
        found = check_scatter(name, g, idx, n, gen)
        tally.max_abs_err = max(tally.max_abs_err, found["vs_plain"])
        flat = (idx.long() + torch.arange(B, device="cuda")[:, None] * n
                ).flatten()
        rows = g.reshape(B * U, C)
        t = cuda_ms(lambda: cuda_scatter.scatter_rows(g, idx, n), 20)
        p = cuda_ms(lambda: plain_scatter(g, idx, n), 5)
        lib = cuda_ms(lambda: torch.zeros(B * n, C, device="cuda").index_add_(
            0, flat, rows), 20)
        bound = tally.add("train", 4 * (B * U * C + B * U + B * n * C),
                          B * U * C, t, p, lib)
        print(f"  {name:22s}: kernel {t:.3f} ms  plain {p:.3f} ms  "
              f"index_add_ {lib:.3f} ms  bound {bound:.3f} ms  longest row "
              f"{found['longest']}; {cuda_scatter.last_plan}; bitwise "
              f"np.add.at, |kernel - plain| {found['vs_plain']:.3g}")
    # heavy collisions, masked centers' zeros, out-of-range indices, odd
    # widths
    zeros = torch.randint(0, 1024, (TRAIN_B, 8192), device="cuda",
                          generator=gen)
    zeros[:, 2048:6144] = 0
    cases = {"collisions": (torch.randint(0, 8, (TRAIN_B, 32768),
                                          device="cuda", generator=gen),
                            2048, 131),
             "row 0": (zeros, 1024, 259),
             "-1 and >= n": (torch.randint(-1, 70, (3, 5000), device="cuda",
                                           generator=gen), 64, 3),
             "C=47": (torch.randint(0, 300, (2, 4096), device="cuda",
                                    generator=gen), 300, 47)}
    for label, (idx, n, C) in cases.items():
        g = 8.0 * torch.randn(*idx.shape, C, device="cuda", generator=gen)
        found = check_scatter(label, g, idx, n, gen)
        t = cuda_ms(lambda: cuda_scatter.scatter_rows(g, idx, n), 5)
        print(f"  {label}: equal on integer g; the same bits in 3 launches; "
              f"bitwise np.add.at; longest row {found['longest']}; "
              f"{cuda_scatter.last_plan}; {t:.3f} ms")
    return tally.summary()


def train_config(ckpt_dir: str) -> Config:
    """Config #3: the default ModelConfig (18 classes), 8 x 40960 points
    of synthetic scenes made on the card, one epoch of 8 steps, no
    evaluation."""
    return Config(
        model=ModelConfig(),
        data=DataConfig(name="synthetic", device_synth=True,
                        num_points=TRAIN_N),
        train=TrainConfig(batch_size=TRAIN_B, num_epochs=1, eval_every=2,
                          log_every=4, ckpt_dir=ckpt_dir))


def grads_of(model, cfg, state, batch, bn_m):
    """(loss, {name: grad}) of one forward + backward in train mode from
    `state`, restored first (the forward moves the BN running stats)."""
    model.load_state_dict(state)
    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = train_lib.detector_loss(model, cfg, batch, bn_m)
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}


def check_precision(nn_calls) -> None:
    """The training step's three_nn calls pick the same neighbours under
    the training precision (TF32 matmuls allowed) as in full fp32; a GEMM
    shows the flag is live."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    x = torch.randn(TRAIN_B * 1024, 256, device="cuda")
    w = torch.randn(256, 256, device="cuda")
    picks, prods = [], []
    for allow in (tf32, False):
        torch.backends.cuda.matmul.allow_tf32 = allow
        picks.append([ops.three_nn(*args, **kw)[1]
                      for args, kw in nn_calls])
        prods.append(x @ w)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    for got, want in zip(*picks):
        require_equal("three_nn under the training precision vs fp32", got,
                      want)
    print(f"  three_nn picks equal with allow_tf32={tf32} and in fp32; a "
          f"[{TRAIN_B * 1024},256]x[256,256] GEMM differs by max "
          f"{(prods[0] - prods[1]).abs().max().item():.3g}")


def phase_train(card: str, gen, nn_calls) -> dict:
    print(f"== training: run_detector, config #3, {TRAIN_B} x {TRAIN_N} "
          f"points, {TRAIN_STEPS} steps")
    ckpt = tempfile.mkdtemp(prefix="tpu3dsad_torch_ckpt_")
    cfg = train_config(ckpt)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result = run_detector(cfg)
    trained = counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"  launches: {trained}")
    if trained != launches(fps=5 * TRAIN_STEPS, ball_query=7 * TRAIN_STEPS,
                           scatter=9 * TRAIN_STEPS):
        raise AssertionError(f"launch counts {trained} != 5, 7 and 9 per "
                             "step")
    losses = [h["loss"] for h in result.history]
    if result.step != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"steps {result.step}, losses {losses}")
    for h in result.history:
        print(f"  step {h['step']}: loss {h['loss']:.6f}  "
              f"{h['seconds'] * 1e3:.3f} ms")
    warm = [h["seconds"] for h in result.history[1:]]
    med = statistics.median(warm)
    print(f"  median warm step {med * 1e3:.3f} ms = {TRAIN_B / med:.2f} "
          f"scenes/s; first step {result.history[0]['seconds'] * 1e3:.3f} "
          f"ms; peak memory allocated {peak / 2**30:.3f} GiB on {card}")

    model = result.model
    fresh = build_detector(cfg, model.mean_sizes).state_dict()
    state = copy.deepcopy(model.state_dict())
    for kind in ("weight", "running_mean", "running_var"):
        if all(torch.equal(state[k], fresh[k]) for k in state
               if k.endswith(kind)):
            raise AssertionError(f"no {kind} moved in training")
    if not (Path(ckpt) / f"ckpt_{TRAIN_STEPS}.pt").exists():
        raise AssertionError(f"no checkpoint at step {TRAIN_STEPS}")
    again = run_detector(cfg)
    if (again.start_step, again.step) != (TRAIN_STEPS, TRAIN_STEPS) or any(
            not torch.equal(v, state[k])
            for k, v in again.model.state_dict().items()):
        raise AssertionError("the second call did not resume the checkpoint")
    print(f"  parameters and BN statistics moved; a second call resumed at "
          f"step {again.start_step} with the saved state")

    check_precision(nn_calls)

    # one step from one state and batch, kernel path vs plain path, in
    # fp32: every kernel on the path gives its plain version's bits (the
    # scatter sums each row in index order, as index_put_ does on the
    # card), so the loss and every gradient must be exactly equal
    batch = synthetic_detection_batch(gen, TRAIN_B, TRAIN_N, 18,
                                      vote_candidates=3)
    bn_m = train_lib.bn_momentum_at(cfg.train, 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts()
    lk, gk = grads_of(model, cfg, state, batch, bn_m)
    one_step = counts()
    with ops.use_impl("plain"):
        lp, gp = grads_of(model, cfg, state, batch, bn_m)
    if counts() != one_step or one_step != launches(fps=5, ball_query=7,
                                                    scatter=9):
        raise AssertionError(f"launches {one_step} then {counts()}")
    if not torch.equal(lk, lp):
        raise AssertionError(f"loss: kernel path {lk.item()!r} vs plain "
                             f"path {lp.item()!r}")
    most = 0.0
    for name, want in gp.items():
        if (at := bits_differ(gk[name], want)) is not None:
            raise AssertionError(f"grad {name}: kernel path != plain path "
                                 f"{at}")
        most = max(most, (gk[name] - want).abs().max().item())
    print(f"  one step, kernel path vs plain path: loss {lk.item():.6f} "
          f"equal; {len(gp)} gradients bitwise equal (max |kernel - plain| "
          f"{most!r})")
    return {"counts": trained, "median_ms": med * 1e3, "peak_bytes": peak}


def phase_fps_flat(gen, scene_call) -> dict:
    print("== large-cloud FPS kernel (B2, cluster) vs plain (exact picks)")
    tally = Tally()
    (xyz, m), kw = scene_call
    n = 100000
    tail = torch.ones(1, n, dtype=torch.bool, device="cuda")
    tail[0, 90000:] = False
    tail[0, ::7] = False
    grid = torch.randint(-6, 7, (1, 8192, 3), device="cuda",
                         generator=gen).float()
    cases = [
        ("eval4 scene", xyz, m, kw.get("mask")),
        ("N=65537", cloud(gen, 1, 65537, -30.0, 30.0), 2048, None),
        ("N=786432", cloud(gen, 1, 786432, -30.0, 30.0), 64, None),
        ("masked tail", cloud(gen, 1, n, -30.0, 30.0), 1024, tail),
        ("all masked", cloud(gen, 1, 70000), 16,
         torch.zeros(1, 70000, dtype=torch.bool, device="cuda")),
        ("duplicates", grid.repeat(1, 10, 1).contiguous(), 1024, None),
    ]
    for label, x, m, mask in cases:
        n = x.shape[1]
        want, p = once_ms(lambda: plain_fps(x, m, mask=mask))
        # the scene three times: a missed fence shows as a rare wrong pick
        for _ in range(3 if label.startswith("eval4") else 1):
            got = cuda_fps.fps_flat(x, m, mask)
            require_equal(f"fps_flat {label}", got, want)
        used, cluster = cuda_fps.last_plan, cuda_fps.last_cluster
        b1, b1_ms = once_ms(lambda: cuda_fps.fps_batched(x, m, mask))
        require_equal(f"fps B1 at B=1 {label}", b1, want)
        k = cuda_ms(lambda: cuda_fps.fps_flat(x, m, mask),
                    5 if label.startswith("eval4") else 3)
        # phase 2's count: 10 fp32 operations a point in each of the m - 1
        # rounds; xyz (and mask) read once, idx written once
        nbytes, nops = n * (12 + (mask is not None)) + m * 4, 10.0 * n * (m - 1)
        if label.startswith("eval4"):
            bound = tally.add("eval4", nbytes, nops, k, p)
        else:
            bound = max(nbytes / HBM_BPS, nops / FP32_FLOPS) * 1e3
        print(f"  {label:12s} [1,{n}]->{m}: kernel {k:.3f} ms "
              f"({k * 1e3 / max(m - 1, 1):.3f} us/round; cluster {cluster}, "
              f"{plan_text(used)})  B1 entry {b1_ms:.3f} ms  plain {p:.3f} "
              f"ms  bound {bound:.3f} ms  equal")
    return tally.summary()


def in_ball_check(label, xyz, centers, r, k, mask, idx, cnt, exact_idx,
                  exact_cnt) -> None:
    """The sorted tier against the exact one: equal counts; where a ball
    holds fewer than K points the same set; where it is full, K distinct
    valid points strictly inside."""
    require_equal(f"{label} cnt vs exact", cnt, exact_cnt)
    K = idx.shape[-1]
    slot = torch.arange(K, device=idx.device)
    live = slot < cnt[..., None]
    n = xyz.shape[1]
    few = cnt < K
    a = torch.where(live, idx, n).sort(-1).values
    b = torch.where(live, exact_idx, n).sort(-1).values
    if not torch.equal(a[few], b[few]):
        raise AssertionError(f"{label}: the sorted tier chose another set "
                             "than the exact tier in a ball of < K points")
    full = a[~few]
    if (full[:, 1:] == full[:, :-1]).any():
        raise AssertionError(f"{label}: a full ball repeats a point")
    B, M, _ = idx.shape
    pts = torch.gather(xyz, 1, idx.reshape(B, M * K, 1).long().expand(
        B, M * K, 3)).reshape(B, M, K, 3)
    d = pts - centers[:, :, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    ok = d2 < radius_sq(r)
    if mask is not None:
        ok &= torch.gather(mask.bool(), 1, idx.reshape(B, M * K).long()
                           ).reshape(B, M, K)
    if not ok[live].all():
        raise AssertionError(f"{label}: a chosen point is not in its ball")


def phase_sorted(gen, eval_calls, serve_sa1, train_sa1) -> dict:
    print(f"== sorted ball query (B4: Morton-code kernel, torch sorts, B3 "
          f"with the map-back in its epilogue) vs glue + plain (exact idx and"
          f" cnt, {COMPARES} calls each)")
    tally = Tally()
    junk = cloud(gen, 4, 8192)
    junk_mask = torch.rand(4, 8192, device="cuda", generator=gen) < 0.7
    junk[~junk_mask] = cloud(gen, 1, int((~junk_mask).sum()), -50.0, 50.0)[0]
    junk_mask[3] = False  # an all-masked cloud
    cases = [("eval4", "config #4 SA1", *eval_calls["ball_query"][0][0],
              eval_calls["ball_query"][0][1].get("mask")),
             ("serve", "config #5 SA1", *serve_sa1[0], serve_sa1[1].get("mask")),
             ("train", "config #3 SA1", *train_sa1[0], train_sa1[1].get("mask")),
             (None, "masked junk, an all-masked cloud", junk,
              junk[:, :1024].contiguous(), 0.3, 32, junk_mask)]
    for path, label, xyz, centers, r, k, mask in cases:
        (b, n), m = xyz.shape[:2], centers.shape[1]
        if not sorted_bq.applies(n, k):
            raise AssertionError(f"{label}: N={n} K={k} is below the gate")
        for got, want in zip(cuda_bq.morton_codes(xyz, centers, mask),
                             sorted_bq.z_keys(xyz, centers, mask)):
            require_equal(f"sorted {label} Morton codes", got, want)
        with ops.use_impl("plain"):
            want = sorted_bq.sorted_ball_query(xyz, centers, r, k, mask=mask)
        for _ in range(COMPARES):
            gi, gc = sorted_bq.sorted_ball_query(xyz, centers, r, k, mask=mask)
            require_equal(f"sorted {label} idx", gi, want[0])
            require_equal(f"sorted {label} cnt", gc, want[1])
        ei, ec = cuda_bq.ball_query(xyz, centers, r, k, mask=mask)
        in_ball_check(f"sorted {label}", xyz, centers, r, k, mask, gi, gc,
                      ei, ec)
        perm, perm_c = sorted_bq.z_order(xyz, centers, mask)
        work = scan_work(xyz, centers, r, k, mask, gi, gc, perm)
        exact_work = scan_work(xyz, centers, r, k, mask, ei, ec)
        per = [tuple(w / (b * m) for w in v) for v in (work, exact_work)]
        if path is None:
            print(f"  {label}: equal (cnt max {gc.max().item()}; sorted "
                  f"{skip_text(per[0])})")
            continue
        t = cuda_ms(lambda: sorted_bq.sorted_ball_query(xyz, centers, r, k,
                                                        mask=mask), 10)
        with ops.use_impl("plain"):
            p = cuda_ms(lambda: sorted_bq.sorted_ball_query(
                xyz, centers, r, k, mask=mask), 2)
        keys = cuda_ms(lambda: sorted_bq.z_order(xyz, centers, mask), 10)
        scan = cuda_ms(lambda: cuda_bq.ball_query(
            xyz, centers, r, k, mask, perm=perm, perm_c=perm_c), 10)
        scan_plan = cuda_bq.last_plan
        exact_ms = cuda_ms(lambda: cuda_bq.ball_query(xyz, centers, r, k,
                                                      mask=mask), 10)
        cost = bq_cost(b, n, m, k, mask, work)
        if path == "eval4":
            bound = tally.add(path, *cost, t, p)
        else:
            bound = max(cost[0] / HBM_BPS, cost[1] / FP32_FLOPS) * 1e3
        print(f"  {label} [{b},{n}] M={m} r={r:g} K={k}: sorted {t:.3f} ms "
              f"(codes + sorts {keys:.3f}, scan with map-back {scan:.3f} "
              f"({scan_plan}); exact kernel {exact_ms:.3f})  plain "
              f"{p:.3f} ms  bound {bound:.3f} ms  equal; sorted "
              f"{skip_text(per[0])}; exact {skip_text(per[1])}; mean cnt "
              f"{gc.float().mean():.2f}")
    return tally.summary()


@contextlib.contextmanager
def stage_clock(stages: dict):
    """Time calls by stage on the host clock, the card synchronised at
    each call's end: stages = {label: [(owner, attribute), ...]}. Yields
    {label: [seconds per call]}; the eval steps that run_eval builds are
    timed under "forward+parse" too, and keep each batch's scene_mask
    count under "scenes"."""
    seen = {label: [] for label in stages}
    seen["scenes"] = []
    originals = []
    for label, targets in stages.items():
        for owner, attr in targets:
            fn = getattr(owner, attr)
            originals.append((owner, attr, fn))

            def timed(*a, _fn=fn, _label=label, **kw):
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                seen[_label].append(time.perf_counter() - t0)
                return out
            setattr(owner, attr, timed)
    make_step = train_lib.make_detector_eval_step

    def counted_step(model, cfg):
        step = make_step(model, cfg)

        def run(batch):
            seen["scenes"].append(int(batch["scene_mask"].sum()))
            t0 = time.perf_counter()
            out = step(batch)
            torch.cuda.synchronize()
            seen["forward+parse"].append(time.perf_counter() - t0)
            return out
        return run
    train_lib.make_detector_eval_step = counted_step
    try:
        yield seen
    finally:
        train_lib.make_detector_eval_step = make_step
        for owner, attr, fn in originals:
            setattr(owner, attr, fn)


def plain_keep(cfg, label: str) -> None:
    """One val batch through the eval step and parse on the kernel path,
    then with the plain ops on the same CUDA tensors: the same keep."""
    dataset = get_dataset(cfg)
    batch = next(dataset.val_batches(np.random.default_rng(0), EVAL_B))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    model = build_detector(cfg, dataset.mean_sizes)
    train_lib.restore_checkpoint(cfg.train.ckpt_dir, model, None,
                                 for_eval=True)
    step = train_lib.make_detector_eval_step(model, cfg)
    keeps = []
    for impl in ("auto", "plain"):
        before = counts()
        with ops.use_impl(impl):
            ep, _ = step(batch)
            keeps.append(eval_detector.parse_predictions(
                ep, model.mean_sizes, cfg.model.num_heading_bins,
                cfg.eval)["keep"])
        if (counts() == before) != (impl == "plain"):
            raise AssertionError(f"{label}: impl {impl} launched "
                                 f"{counts()} from {before}")
    require_equal(f"keep {label} (kernel path vs plain path)", *keeps)
    print(f"  {label}: one batch on the plain ops gives the same keep "
          f"({int(keeps[0].sum())} boxes kept)")


def phase_eval(card: str, outdoor: dict) -> dict:
    print(f"== config #4 evaluation: run_eval over {EVAL_SCENES} scenes x "
          f"{EVAL_RAW_N} points, batch {EVAL_B}, twice")
    val = Path(outdoor["sweep"]) / "val"
    batches = -(-EVAL_SCENES // EVAL_B)
    sweeps = {}
    for sweep, extra, want in (
            ("exact", [], launches(fps=5 * batches, fps_flat=EVAL_SCENES,
                                   ball_query=7 * batches)),
            ("sorted", SORTED_ARGS, launches(fps=5 * batches,
                                             ball_query=7 * batches,
                                             sorted=batches))):
        cfg = eval_config(outdoor["sweep"], outdoor["ckpt"], *extra)
        stages = {"crop+fps": [(kitti, "range_crop"), (kitti, "device_fps")],
                  "forward+parse": [(eval_detector, "parse_predictions")],
                  "ap": [(train_detector, "predictions_to_lists"),
                         (train_detector, "parse_groundtruths"),
                         (APCalculator, "step"),
                         (APCalculator, "compute_metrics")]}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with stage_clock(stages) as t:
            t0 = time.perf_counter()
            out = eval_detector.run_eval(cfg)
            wall = time.perf_counter() - t0
        got = counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"  {sweep} sweep launches: {got}")
        if got != want:
            raise AssertionError(f"{sweep} sweep: launches {got} != {want}")
        if t["scenes"] != [EVAL_B, EVAL_SCENES - EVAL_B]:
            raise AssertionError(f"{sweep} sweep: batches of scenes "
                                 f"{t['scenes']}, not [8, 4] with padding")
        for thresh in cfg.eval.ap_iou_threshs:
            for key in (f"mAP@{thresh}", f"AR@{thresh}"):
                if not 0.0 <= out[key] <= 1.0:
                    raise AssertionError(f"{sweep} sweep: {key} {out[key]}")
        if out["ckpt_step"] != 1 or not np.isfinite(out["val_loss"]):
            raise AssertionError(f"{sweep} sweep: {out}")
        caches = sorted(val.glob(f"*_fpscache_{EVAL_N}.npy"))
        if len(caches) != EVAL_SCENES:
            raise AssertionError(f"{len(caches)} FPS caches written, not "
                                 f"{EVAL_SCENES}")
        # forward+parse: the eval step (forward and loss) and the parse
        crop = sum(t["crop+fps"]) / EVAL_SCENES
        fwd = sum(t["forward+parse"]) / batches
        ap = sum(t["ap"]) / batches
        sweeps[sweep] = {"counts": got, "scenes_per_s": EVAL_SCENES / wall,
                         "peak_bytes": peak}
        print(f"  {sweep} sweep: {EVAL_SCENES / wall:.3f} scenes/s ({wall:.3f}"
              f" s); crop + FPS {crop * 1e3:.3f} ms per scene; forward + parse "
              f"{fwd * 1e3:.3f} ms per batch; host AP "
              f"{ap * 1e3:.3f} ms per batch; peak memory allocated "
              f"{peak / 2**30:.3f} GiB on {card}")
    for sweep, extra in (("exact", []), ("sorted", SORTED_ARGS)):
        cfg = eval_config(outdoor["sweep"], outdoor["ckpt"], *extra)
        train_lib.apply_runtime_config(cfg)
        plain_keep(cfg, sweep)
    train_lib.apply_runtime_config(Config())
    return sweeps


def main() -> None:
    card = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    work = Path(tempfile.mkdtemp(prefix="tpu3dsad_torch_outdoor_"))
    try:
        outdoor = prepare_outdoor(work)
        train_calls = capture_train_step(gen)
        eval_loads, eval_calls = capture_eval_batch(outdoor)
        serve_calls = capture_request()
        fps_t = phase_fps(gen, train_calls, eval_calls)
        bq_t = phase_ball_query(gen, serve_calls, train_calls, eval_calls)
        served = phase_serve(card)
        scatter_t = phase_scatter(gen, train_calls)
        nn_calls = train_calls["three_nn"]
        train_sa1 = train_calls["ball_query"][0]
        serve_sa1 = serve_calls["ball_query"][0]
        del serve_calls
        del train_calls  # keep the recorded tensors out of training's peak
        trained = phase_train(card, gen, nn_calls)
        flat_t = phase_fps_flat(gen, eval_loads["fps"][0])
        del eval_loads
        sorted_t = phase_sorted(gen, eval_calls, serve_sa1, train_sa1)
        evaluated = phase_eval(card, outdoor)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    jax_side = [m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "tpu3dsad")]
    if jax_side:
        raise AssertionError(f"the port imported JAX or its package: "
                             f"{jax_side}")
    paths = {"serve": served["counts"], "train": trained["counts"],
             "eval4": {**evaluated["exact"]["counts"],
                       "sorted": evaluated["sorted"]["counts"]["sorted"]}}

    def entry(name, counter, source, replaces, times):
        for path, t in times["by_path"].items():
            t["launches"] = paths[path][counter]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(c[counter] for c in paths.values()), **times}

    kernels = [
        entry("fps", "fps", "tpu3dsad_torch/csrc/fps.cu",
              "tpu3dsad/ops/pallas/fps.py:44", fps_t),
        entry("fps_flat", "fps_flat", "tpu3dsad_torch/csrc/fps.cu",
              "tpu3dsad/ops/pallas/fps.py:142", flat_t),
        entry("ball_query", "ball_query", "tpu3dsad_torch/csrc/ball_query.cu",
              "tpu3dsad/ops/pallas/ball_query.py:54", bq_t),
        entry("sorted_ball_query", "sorted",
              "tpu3dsad_torch/ops/sorted.py + tpu3dsad_torch/csrc/"
              "ball_query.cu", "tpu3dsad/ops/pallas/ball_query.py:282",
              sorted_t),
        entry("scatter_rows", "scatter", "tpu3dsad_torch/csrc/scatter.cu",
              "tpu3dsad/ops/pallas/scatter.py:92", scatter_t),
    ]
    print("kernel ms / plain_ms / library_ms / bound_ms: summed over the "
          "main-path shapes of one served request (32 x 20480), one "
          "config-#3 training step (8 x 40960) and one config-#4 eval batch "
          "(8 x 16384; fps_flat: one scene), each path's own under by_path;"
          f" launches: the {REQUESTS} served requests, the {TRAIN_STEPS} "
          "training steps and one config-#4 sweep of "
          f"{EVAL_SCENES} scenes (exact grouping; sorted_ball_query: the "
          "sweep with ops_fast_mode=sorted)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
