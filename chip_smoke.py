#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tpu3dsad_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

 1. device and build: the card's name and power limit (nvidia-smi), then
    nvcc builds the kernels from tpu3dsad_torch/csrc, one process per
    source, all at once; then one forward + backward of the config-#3
    training step, recording the inputs of each of its kernel launches
    (and three_nn calls) for the phases below;
 2. the FPS kernel against its plain PyTorch version on the card, at the 5
    shapes of a served request and on the 5 recorded inputs of the
    training step, plus masked, all-masked and tied clouds: picks must be
    exactly equal;
 3. the ball-query kernel against its plain version, at the 7 shapes of a
    request and on the 7 recorded inputs of the training step, plus masked
    points, empty balls and saturated balls: idx and cnt must be exactly
    equal;
 4. serving: SizeAdaptiveDetector(ModelConfig(num_classes=10)) with seeded
    random weights answers requests of 32 scenes x 20480 points through
    serving.build_inference_fn: one warm-up request, then the counted and
    timed ones. Outputs must be finite and of the right shapes, the launch
    counters must show 5 FPS and 7 ball-query launches per request and no
    scatter, and one request rerun with the plain ops on the same CUDA
    tensors must give the same keep mask;
 5. the scatter kernel (the gather/group backward) against its plain
    version on the 9 recorded launches of the training step (its own
    gradients and indices), plus heavy collisions, -1 / >= n indices and
    an odd width: exactly equal on integer-valued gradients of each shape,
    and within the fp32 summation bound of a float64 reference on the
    step's own gradients (normal ones for the extra cases);
 6. training: train_detector.run_detector at config #3 (ModelConfig(), 18
    classes, 8 scenes x 40960 points, synthetic batches made on the card)
    for one epoch of 8 steps. Losses must be finite, the counters must show
    5 FPS, 7 ball-query and 9 scatter launches per step, parameters and BN
    statistics must have moved, the checkpoint must resume at step 8,
    the step's three_nn calls must pick the same indices under the
    training precision as in full fp32, and one step from one saved state
    and batch must give the same loss on the kernel path and the plain
    path, with gradients within the tolerance the scatter's atomic order
    allows.

Both sides of each comparison run on the same card; a differing pick is
printed, never hidden by a tolerance. Kernel times are CUDA-event means
over repeated launches; bound_ms is the least time the card could take for
the same work at NVIDIA's published H100 SXM peaks (3.35 TB/s; 67 TFLOP/s
fp32 outside the tensor cores). The line before the last is a JSON summary
of the kernels: times summed over one request and one training step, and
each path's own under by_path; the last line names the device.
"""

from __future__ import annotations

import contextlib
import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tpu3dsad_torch import ops, train_lib
from tpu3dsad_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from tpu3dsad_torch.data import get_dataset
from tpu3dsad_torch.data.device_pipeline import synthetic_detection_batch
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.ops.cuda import ball_query as cuda_bq
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda import fps as cuda_fps
from tpu3dsad_torch.ops.cuda import scatter as cuda_scatter
from tpu3dsad_torch.ops.plain import ball_query as plain_bq
from tpu3dsad_torch.ops.plain import furthest_point_sample as plain_fps
from tpu3dsad_torch.ops.plain import scatter_rows as plain_scatter
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
    return {"fps": cuda_fps.launches, "ball_query": cuda_bq.launches,
            "scatter": cuda_scatter.launches}


def reset_counts() -> None:
    cuda_fps.launches = cuda_bq.launches = cuda_scatter.launches = 0


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
        if "entry function" in line or "registers" in line:
            print(f"  ptxas: {line.strip()}")
    return card


@contextlib.contextmanager
def recording():
    """Record the inputs of every FPS, ball-query and scatter launch and
    every three_nn call in the block, {kind: [(args, kwargs)]} with the
    tensors cloned; each call goes on to the kernel (or three_nn)."""
    calls = {"fps": [], "ball_query": [], "scatter": [], "three_nn": []}
    targets = [(cuda_fps, "furthest_point_sample", "fps"),
               (cuda_bq, "ball_query", "ball_query"),
               (cuda_scatter, "scatter_rows", "scatter"),
               (ops, "three_nn", "three_nn")]
    originals = [getattr(mod, attr) for mod, attr, _ in targets]

    def clone(a):
        return a.detach().clone() if torch.is_tensor(a) else a

    for (mod, attr, kind), fn in zip(targets, originals):
        def record(*args, _fn=fn, _kind=kind, **kw):
            calls[_kind].append(([clone(a) for a in args],
                                 {k: clone(v) for k, v in kw.items()}))
            return _fn(*args, **kw)
        setattr(mod, attr, record)
    try:
        yield calls
    finally:
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


def phase_fps(gen, train_calls) -> dict:
    print("== FPS kernel vs plain (exact picks)")
    tally = Tally()
    names = [name for name, _, _ in FPS_SHAPES]
    cases = [("serve", name, cloud(gen, B, n), m, None)
             for name, n, m in FPS_SHAPES]
    cases += [("train", name, args[0], args[1], kw.get("mask"))
              for name, (args, kw) in zip(names, train_calls["fps"])]
    for path, name, xyz, m, mask in cases:
        b, n = xyz.shape[:2]
        got = cuda_fps.furthest_point_sample(xyz, m, mask=mask)
        require_equal(f"fps {path} {name}", got,
                      plain_fps(xyz, m, mask=mask))
        k = cuda_ms(lambda: cuda_fps.furthest_point_sample(xyz, m, mask=mask),
                    10)
        p = cuda_ms(lambda: plain_fps(xyz, m, mask=mask), 2)
        # each of the m - 1 rounds: 3 sub, 3 mul, 2 add, min, compare per
        # point; xyz (and mask) read once, idx written once
        bound = tally.add(path, b * n * (12 + (mask is not None)) + b * m * 4,
                          10.0 * b * n * (m - 1), k, p)
        print(f"  {path} {name:9s} [{b},{n}]->{m}: kernel {k:.3f} ms  plain "
              f"{p:.3f} ms  bound {bound:.3f} ms  equal")
    # masked tail, an all-masked cloud, and exact distance ties on a grid
    xyz = cloud(gen, 4, N)
    mask = torch.ones(4, N, dtype=torch.bool, device="cuda")
    mask[0, N // 3:] = False
    mask[1] = False
    mask[2, ::2] = False
    tied = torch.randint(-4, 5, (4, 4096, 3), device="cuda",
                         generator=gen).float()
    for label, (x, mk, m) in {"masked": (xyz, mask, 2048),
                              "ties": (tied, None, 512)}.items():
        got = cuda_fps.furthest_point_sample(x, m, mask=mk)
        require_equal(f"fps {label}", got, plain_fps(x, m, mask=mk))
        print(f"  {label}: equal")
    return tally.summary()


def phase_ball_query(gen, train_calls) -> dict:
    print("== ball-query kernel vs plain (exact idx and cnt)")
    tally = Tally()
    cases = []
    for name, n, m, r, k in BQ_SHAPES:
        xyz = cloud(gen, B, n)
        cases.append(("serve", name, xyz, xyz[:, :m].contiguous(), r, k, None))
    names = [name for name, *_ in BQ_SHAPES]
    cases += [("train", name, *args, kw.get("mask"))
              for name, (args, kw) in zip(names, train_calls["ball_query"])]
    for path, name, xyz, centers, r, k, mask in cases:
        (b, n), m = xyz.shape[:2], centers.shape[1]
        gi, gc = cuda_bq.ball_query(xyz, centers, r, k, mask=mask)
        pi, pc = plain_bq(xyz, centers, r, k, mask=mask)
        require_equal(f"ball_query {path} {name} idx", gi, pi)
        require_equal(f"ball_query {path} {name} cnt", gc, pc)
        t = cuda_ms(lambda: cuda_bq.ball_query(xyz, centers, r, k, mask=mask),
                    10)
        p = cuda_ms(lambda: plain_bq(xyz, centers, r, k, mask=mask), 2)
        # this data's work: each center scans points in order up to its
        # K-th hit (all n if it has fewer), 3 sub + 3 mul + 2 add + compare
        # per point; xyz (and mask) and centers read once, idx and cnt
        # written once
        scanned = torch.where(gc == k, gi[..., -1].long() + 1, n).sum()
        bound = tally.add(
            path, b * n * (12 + (mask is not None)) + b * m * 12
            + b * m * (k + 1) * 4, 9.0 * scanned.item(), t, p)
        print(f"  {path} {name:9s} N={n} M={m} r={r:g} K={k}: kernel {t:.3f}"
              f" ms  plain {p:.3f} ms  bound {bound:.3f} ms  equal (mean cnt"
              f" {gc.float().mean():.2f})")
    # masked points, empty balls (far centers), saturated balls, K > N
    xyz = cloud(gen, 4, 4096, -0.5, 0.5)
    mask = torch.rand(4, 4096, device="cuda", generator=gen) < 0.7
    mask[3] = False
    centers = torch.cat([xyz[:, :200], cloud(gen, 4, 56, 5.0, 6.0)], 1)
    cases = {"masked+empty": (xyz, centers, mask, 0.1, 32),
             "saturated": (xyz, centers, None, 0.3, 64),
             "K>N": (xyz[:, :40].contiguous(), centers, None, 0.4, 64)}
    for label, (x, c, mk, r, k) in cases.items():
        gi, gc = cuda_bq.ball_query(x, c, r, k, mask=mk)
        pi, pc = plain_bq(x, c, r, k, mask=mk)
        require_equal(f"ball_query {label} idx", gi, pi)
        require_equal(f"ball_query {label} cnt", gc, pc)
        print(f"  {label}: equal (cnt min {gc.min().item()} max "
              f"{gc.max().item()})")
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
    if served != {"fps": 5 * REQUESTS, "ball_query": 7 * REQUESTS,
                  "scatter": 0}:
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


def check_scatter(name, g, idx, n, gen) -> float:
    """Kernel vs plain on integer-valued gradients of g's shape (exact in
    any order), then on g itself against a float64 plain result within the
    fp32 summation bound. Returns the max abs difference on g."""
    whole = torch.randint(-64, 65, g.shape, device="cuda",
                          generator=gen).float()
    got = cuda_scatter.scatter_rows(whole, idx, n)
    want = plain_scatter(whole, idx, n)
    if not torch.equal(got, want):
        diff = (got - want).abs()
        at = tuple(torch.nonzero(diff)[0].tolist())
        raise AssertionError(f"scatter {name}: kernel != plain on integer g "
                             f"at {at}: {got[at].item()} vs {want[at].item()}")
    got = cuda_scatter.scatter_rows(g, idx, n)
    ref = plain_scatter(g.double(), idx, n)
    # recursive fp32 summation of k addends errs by at most
    # (k - 1) * 2^-24 * sum |addends|; twice that is the bar
    k = plain_scatter(torch.ones_like(g[..., :1]), idx, n)
    limit = k * 2.0 ** -23 * plain_scatter(g.double().abs(), idx, n)
    err = (got.double() - ref).abs()
    if (err > limit).any():
        at = tuple(torch.nonzero(err > limit)[0].tolist())
        raise AssertionError(f"scatter {name}: |kernel - fp64| {err[at]:.3g} "
                             f"above the bound {limit[at]:.3g} at {at}")
    return err.max().item()


def phase_scatter(gen, train_calls) -> dict:
    print("== scatter kernel vs plain at the training step's launches "
          "(exact on integer g, fp64 bound on the step's own g)")
    tally = Tally()
    for args, _ in train_calls["scatter"]:
        g, idx, n = args
        B, U, C = g.shape
        name = f"n={n} U={U} C={C}"
        tally.max_abs_err = max(tally.max_abs_err,
                                check_scatter(name, g, idx, n, gen))
        flat = (idx.long() + torch.arange(B, device="cuda")[:, None] * n
                ).flatten()
        rows = g.reshape(B * U, C)
        t = cuda_ms(lambda: cuda_scatter.scatter_rows(g, idx, n), 20)
        p = cuda_ms(lambda: plain_scatter(g, idx, n), 5)
        lib = cuda_ms(lambda: torch.zeros(B * n, C, device="cuda").index_add_(
            0, flat, rows), 20)
        bound = tally.add("train", 4 * (B * U * C + B * U + B * n * C),
                          B * U * C, t, p, lib)
        most = torch.bincount(flat, minlength=B * n).max().item()
        print(f"  {name:22s}: kernel {t:.3f} ms  plain {p:.3f} ms  "
              f"index_add_ {lib:.3f} ms  bound {bound:.3f} ms  equal (most "
              f"adds to one row {most}, max |g| {g.abs().max().item():.3g})")
    # heavy collisions, out-of-range indices, odd widths
    cases = {"collisions": (torch.randint(0, 8, (TRAIN_B, 32768),
                                          device="cuda", generator=gen),
                            2048, 131),
             "-1 and >= n": (torch.randint(-1, 70, (3, 5000), device="cuda",
                                           generator=gen), 64, 3),
             "C=47": (torch.randint(0, 300, (2, 4096), device="cuda",
                                    generator=gen), 300, 47)}
    for label, (idx, n, C) in cases.items():
        g = 8.0 * torch.randn(*idx.shape, C, device="cuda", generator=gen)
        e = check_scatter(label, g, idx, n, gen)
        print(f"  {label}: equal on integer g, max |err| {e:.3g} on normal g")
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
    if trained != {"fps": 5 * TRAIN_STEPS, "ball_query": 7 * TRAIN_STEPS,
                   "scatter": 9 * TRAIN_STEPS}:
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
    # fp32 so that the gradients differ by the scatter's add order alone
    batch = synthetic_detection_batch(gen, TRAIN_B, TRAIN_N, 18,
                                      vote_candidates=3)
    bn_m = train_lib.bn_momentum_at(cfg.train, 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts()
    lk, gk = grads_of(model, cfg, state, batch, bn_m)
    one_step = counts()
    with ops.use_impl("plain"):
        lp, gp = grads_of(model, cfg, state, batch, bn_m)
    if counts() != one_step or one_step != {"fps": 5, "ball_query": 7,
                                            "scatter": 9}:
        raise AssertionError(f"launches {one_step} then {counts()}")
    if not torch.equal(lk, lp):
        raise AssertionError(f"loss: kernel path {lk.item()!r} vs plain "
                             f"path {lp.item()!r}")
    gmax = max(g.abs().max().item() for g in gp.values())
    worst = ("", 0.0)
    for name, want in gp.items():
        err = (gk[name] - want).abs().max().item()
        limit = GRAD_RTOL * want.abs().max().item() + GRAD_ATOL * gmax
        if err > limit:
            raise AssertionError(f"grad {name}: max |kernel - plain| {err:.3g}"
                                 f" above {limit:.3g}")
        if err / limit > worst[1]:
            worst = (name, err / limit)
    print(f"  one step, kernel path vs plain path: loss {lk.item():.6f} "
          f"equal; {len(gp)} gradients within tolerance (worst {worst[0]} "
          f"at {worst[1]:.3f} of its limit; largest |grad| {gmax:.3g})")
    return {"counts": trained, "median_ms": med * 1e3, "peak_bytes": peak}


# Gradients of the kernel path vs the plain path: the scatter adds in
# atomic order, the plain version in index order, so the sums differ in
# their last bits and the difference carries through the rest of the
# backward. Per parameter tensor, max |kernel - plain| <= GRAD_RTOL x its
# own max |grad| + GRAD_ATOL x the largest |grad| of the model; the second
# term covers tensors whose gradient is rounding noise in both paths (the
# bias of a Linear feeding a train-mode BatchNorm is zero in exact
# arithmetic).
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def main() -> None:
    card = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    train_calls = capture_train_step(gen)
    fps_t = phase_fps(gen, train_calls)
    bq_t = phase_ball_query(gen, train_calls)
    served = phase_serve(card)
    scatter_t = phase_scatter(gen, train_calls)
    nn_calls = train_calls["three_nn"]
    del train_calls  # keep the recorded tensors out of training's peak
    trained = phase_train(card, gen, nn_calls)
    jax_side = [m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "tpu3dsad")]
    if jax_side:
        raise AssertionError(f"the port imported JAX or its package: "
                             f"{jax_side}")
    paths = {"serve": served["counts"], "train": trained["counts"]}

    def entry(name, counter, source, replaces, times):
        for path, t in times["by_path"].items():
            t["launches"] = paths[path][counter]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(c[counter] for c in paths.values()), **times}

    kernels = [
        entry("fps", "fps", "tpu3dsad_torch/csrc/fps.cu",
              "tpu3dsad/ops/pallas/fps.py:44", fps_t),
        entry("ball_query", "ball_query", "tpu3dsad_torch/csrc/ball_query.cu",
              "tpu3dsad/ops/pallas/ball_query.py:54", bq_t),
        entry("scatter_rows", "scatter", "tpu3dsad_torch/csrc/scatter.cu",
              "tpu3dsad/ops/pallas/scatter.py:92", scatter_t),
    ]
    print("kernel ms / plain_ms / library_ms / bound_ms: summed over the "
          "main-path shapes of one served request (32 x 20480) and one "
          "config-#3 training step (8 x 40960), each path's own under "
          f"by_path; launches: the {REQUESTS} served requests and the "
          f"{TRAIN_STEPS} training steps")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
