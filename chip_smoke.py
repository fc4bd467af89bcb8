#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tpu3dsad_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

 1. device and build: the card's name and power limit (nvidia-smi), then
    nvcc builds the kernels from tpu3dsad_torch/csrc;
 2. the FPS kernel against its plain PyTorch version on the card, at the 5
    shapes of the whole-scene program plus masked, all-masked and tied
    clouds: picks must be exactly equal;
 3. the ball-query kernel against its plain version, at the 7 shapes of the
    program plus masked points, empty balls and saturated balls: idx and cnt
    must be exactly equal;
 4. serving: SizeAdaptiveDetector(ModelConfig(num_classes=10)) with seeded
    random weights answers requests of 32 scenes x 20480 points through
    serving.build_inference_fn: one warm-up request, then the counted and
    timed ones. Outputs must be finite and of the right shapes, the launch
    counters must show 5 FPS and 7 ball-query launches per request, and one
    request rerun with the plain ops on the same CUDA tensors must give the
    same keep mask.

Both sides of each comparison run the same fp32 operations on the same
card, so equality is the bar; a differing pick is printed, never hidden by
a tolerance. Kernel times are CUDA-event means over repeated launches.
The line before the last is a JSON summary of the kernels; the last line
names the device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tpu3dsad_torch import ops
from tpu3dsad_torch.config import Config, ModelConfig
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.ops.cuda import ball_query as cuda_bq
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda import fps as cuda_fps
from tpu3dsad_torch.ops.plain import ball_query as plain_bq
from tpu3dsad_torch.ops.plain import furthest_point_sample as plain_fps
from tpu3dsad_torch.serving import build_inference_fn

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


def phase_fps(gen) -> dict:
    print("== FPS kernel vs plain (exact picks)")
    ms = plain_ms = 0.0
    err = 0
    for name, n, m in FPS_SHAPES:
        xyz = cloud(gen, B, n)
        got = cuda_fps.furthest_point_sample(xyz, m)
        err = max(err, require_equal(f"fps {name}", got, plain_fps(xyz, m)))
        k = cuda_ms(lambda: cuda_fps.furthest_point_sample(xyz, m), 10)
        p = cuda_ms(lambda: plain_fps(xyz, m), 2)
        ms, plain_ms = ms + k, plain_ms + p
        print(f"  {name:9s} [{B},{n}]->{m}: kernel {k:.3f} ms  plain "
              f"{p:.3f} ms  equal")
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
        err = max(err, require_equal(f"fps {label}", got,
                                     plain_fps(x, m, mask=mk)))
        print(f"  {label}: equal")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_ball_query(gen) -> dict:
    print("== ball-query kernel vs plain (exact idx and cnt)")
    ms = plain_ms = 0.0
    err = 0
    for name, n, m, r, k in BQ_SHAPES:
        xyz = cloud(gen, B, n)
        centers = xyz[:, :m].contiguous()
        gi, gc = cuda_bq.ball_query(xyz, centers, r, k)
        pi, pc = plain_bq(xyz, centers, r, k)
        err = max(err, require_equal(f"ball_query {name} idx", gi, pi),
                  require_equal(f"ball_query {name} cnt", gc, pc))
        t = cuda_ms(lambda: cuda_bq.ball_query(xyz, centers, r, k), 10)
        p = cuda_ms(lambda: plain_bq(xyz, centers, r, k), 2)
        ms, plain_ms = ms + t, plain_ms + p
        print(f"  {name:9s} N={n} M={m} r={r} K={k}: kernel {t:.3f} ms  "
              f"plain {p:.3f} ms  equal (mean cnt {gc.float().mean():.2f})")
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
        err = max(err, require_equal(f"ball_query {label} idx", gi, pi),
                  require_equal(f"ball_query {label} cnt", gc, pc))
        print(f"  {label}: equal (cnt min {gc.min().item()} max "
              f"{gc.max().item()})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def build_server():
    """(cfg, model, infer): the config #5 detector with seeded random
    weights on the card, behind serving.build_inference_fn."""
    cfg = Config(model=ModelConfig(num_classes=10))
    model = SizeAdaptiveDetector(cfg.model, device="cuda",
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

    cuda_fps.launches = cuda_bq.launches = 0
    times, outs = [], []
    for pts, mask in batches:
        t0 = time.perf_counter()
        out = infer(pts, mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    counts = {"fps": cuda_fps.launches, "ball_query": cuda_bq.launches}
    print(f"  launches: {counts}")
    if counts != {"fps": 5 * REQUESTS, "ball_query": 7 * REQUESTS}:
        raise AssertionError(f"launch counts {counts} != 5 and 7 per request")

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
    if (cuda_fps.launches, cuda_bq.launches) != tuple(counts.values()):
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
    return {"counts": counts, "median_ms": med * 1e3}


def main() -> None:
    card = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    fps_t = phase_fps(gen)
    bq_t = phase_ball_query(gen)
    served = phase_serve(card)
    jax_side = [m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "tpu3dsad")]
    if jax_side:
        raise AssertionError(f"the port imported JAX or its package: "
                             f"{jax_side}")
    kernels = [
        {"name": "fps", "route": "cuda", "source": "tpu3dsad_torch/csrc/fps.cu",
         "replaces": "tpu3dsad/ops/pallas/fps.py:44",
         "launches": served["counts"]["fps"], **fps_t},
        {"name": "ball_query", "route": "cuda",
         "source": "tpu3dsad_torch/csrc/ball_query.cu",
         "replaces": "tpu3dsad/ops/pallas/ball_query.py:54",
         "launches": served["counts"]["ball_query"], **bq_t},
    ]
    print("kernel ms / plain_ms: summed over one request's main-path shapes")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
