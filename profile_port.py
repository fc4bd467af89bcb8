#!/usr/bin/env python3
"""Where one request's, or one training step's, time goes in the PyTorch /
CUDA port, on one GPU.

    python3 profile_port.py [--trace PATH]          # serving, config #5
    python3 profile_port.py --train [--trace PATH]  # training, config #3
    python3 profile_port.py --eval [--trace PATH]   # evaluation, config #4
    python3 profile_port.py --fps                   # FPS per call and plan
    python3 profile_port.py --ball-query            # ball query per call and plan

Serving drives the program of chip_smoke.py (BASELINE config #5: 32 scenes
x 20480 points, seeded random weights, served through
serving.build_inference_fn) and prints:

 1. the host wall ms of each timed request (synchronised after each);
 2. device ms per stage, the median over REQUESTS requests of the time
    between CUDA events recorded by forward pre/post hooks: SA1-4 and their
    shared MLPs, FP1-2, voting, the proposal stage and its bank MLPs, and
    the whole forward. parse + NMS runs from the forward's end to the
    request's end. Nothing synchronises inside a request;
 3. torch.profiler over PROFILED requests: ops and kernels by self device
    time, then the device's busy share, the union of the kernel intervals
    over the span from the first kernel's start to the last kernel's end.

WARMUP requests run first and are not timed. The chrome trace is written
to --trace (default build/profile/request_trace.json).

--train does the same for the train step of chip_smoke.py's phase 6
(config #3: 8 scenes x 40960 points, 18 classes, train.bf16_matmul on, so
the MLP products may run as TF32): batch generation, forward + loss (with
the forward's stages), backward and optimizer, as CUDA-event medians over
REQUESTS steps after WARMUP; then torch.profiler over PROFILED steps, the
busy share, and the kernels by device time with the GEMM kernels listed
apart, so their names show which precision cuBLAS ran.

--eval does it for one batch of chip_smoke.py's phase 9 (config #4:
preset=outdoor, 8 scenes of 122880 raw points cropped and sampled to
16384 by the cluster FPS, seeded random weights): the eval step (forward
and loss) with the forward's stages, and the parse, as CUDA-event medians
over REQUESTS batches after WARMUP, then torch.profiler over PROFILED
batches. Loading the batch (crop, FPS, votes) is the host's and is timed
by the smoke.

--fps times the FPS kernel (csrc/fps.cu) at each main-path FPS call (the 5
of a request, a train step and an eval batch, and one config-#4 scene),
on seeded clouds, at the plan that ops/cuda/fps.py chooses and then at
each cluster size that fits the card in each register tier: each launch
is first held equal to the plain version, then timed by CUDA events (ms
and us a round).

--ball-query times the ball-query kernel (csrc/ball_query.cu) at each
main-path ball-query call, on the inputs recorded from one served request,
one config-#3 train step and one config-#4 eval batch (chip_smoke.py's
recorders): exact, then the three SA1 calls through the sorted tier (the
scan alone, on the Z-order permutations, and the whole call). Each call
runs at the plan that ops/cuda/ball_query.py chooses and then at every
other shape (warps a block x centers a warp x loads from global or
shared memory); each launch is first held equal to the plain version (the
glue + plain for the sorted tier), then timed by CUDA events. About 500
lines: redirect them to a file.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (
    BQ_SHAPES,
    EVAL_B,
    EVAL_N,
    FPS_SHAPES,
    TRAIN_B,
    TRAIN_N,
    B,
    N,
    build_server,
    capture_eval_batch,
    capture_request,
    capture_train_step,
    cuda_ms,
    eval_config,
    make_requests,
    phase_device,
    plan_text,
    prepare_outdoor,
    require_equal,
    train_config,
)
from tpu3dsad_torch import train_lib
from tpu3dsad_torch.data import get_dataset
from tpu3dsad_torch.eval.parse import parse_predictions
from tpu3dsad_torch.data.device_pipeline import synthetic_detection_batch
from tpu3dsad_torch import ops
from tpu3dsad_torch.ops import sorted as sorted_bq
from tpu3dsad_torch.ops.cuda import ball_query as cuda_bq
from tpu3dsad_torch.ops.cuda import fps as cuda_fps
from tpu3dsad_torch.ops.plain import ball_query as plain_bq
from tpu3dsad_torch.ops.plain import furthest_point_sample as plain_fps
from tpu3dsad_torch.train_detector import build_detector

# the bucketed crop of a config-#4 scene of 122880 raw points (4096s)
SCENE_N = 118784

REQUESTS, WARMUP, PROFILED = 5, 3, 3


def stage_modules(model) -> dict:
    """name -> module, for the stages a request runs once each."""
    bb, prop = model.backbone, model.proposal
    mods = {}
    for i in range(1, 5):
        sa = getattr(bb, f"sa{i}")
        mods[f"sa{i}"] = sa
        mods[f"sa{i}.mlp"] = sa.mlp_0
    mods["fp1"], mods["fp2"] = bb.fp1, bb.fp2
    mods["voting"] = model.voting
    for r in range(len(prop.radius_bank)):
        mods[f"proposal.scale_mlp_{r}"] = getattr(prop, f"scale_mlp_{r}")
    mods["proposal"] = prop
    mods["forward"] = model
    return mods


def hook_events(mods: dict) -> tuple[dict, list]:
    """Record a CUDA event before and after each module's forward.
    Returns ({name: [start, end]} refilled every request, hook handles)."""
    events: dict = {}
    handles = []

    def marker(name, slot):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.setdefault(name, [None, None])[slot] = ev
        return hook

    for name, mod in mods.items():
        handles.append(mod.register_forward_pre_hook(marker(name, 0)))
        handles.append(mod.register_forward_hook(marker(name, 1)))
    return events, handles


def busy_share(trace_events: list) -> tuple[int, float, float]:
    """(kernels, busy us, span us) of the chrome-trace events of category
    'kernel': busy is the union of their intervals, span runs from the first
    kernel's start to the last kernel's end."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace_events
                   if e.get("cat") == "kernel")
    if not spans:
        raise RuntimeError("the trace holds no kernel: no device time seen")
    busy, run_start, run_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > run_end:
            busy += run_end - run_start
            run_start, run_end = start, end
        else:
            run_end = max(run_end, end)
    busy += run_end - run_start
    return len(spans), busy, max(e for _, e in spans) - spans[0][0]


def kernel_times(trace_events: list) -> list[tuple[str, float, int]]:
    """(name, device us, launches) of each kernel in a chrome trace, most
    time first."""
    acc: dict = {}
    for e in trace_events:
        if e.get("cat") == "kernel":
            us, n = acc.get(e["name"], (0.0, 0))
            acc[e["name"]] = (us + e["dur"], n + 1)
    return sorted(((k, us, n) for k, (us, n) in acc.items()),
                  key=lambda r: -r[1])


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(tag in low for tag in ("gemm", "xmma", "cutlass", "wgmma"))


def print_trace(prof, path: Path, card: str, what: str) -> list:
    """Export the profile's chrome trace to `path`, print the busy share,
    and return the trace events."""
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())["traceEvents"]
    n, busy, span = busy_share(trace)
    print(f"kernels: {n}; busy {busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms "
          f"kernel span = {busy / span:.3f} busy share over {what}; {card}")
    return trace


def profile_serve(card: str, trace_path: Path) -> None:
    _, model, infer = build_server()
    batches = make_requests(REQUESTS, seed=0)  # PROFILED <= REQUESTS
    for i in range(WARMUP):
        infer(*batches[i % len(batches)])
    torch.cuda.synchronize()

    events, handles = hook_events(stage_modules(model))
    walls, per_stage = [], {}
    for batch in batches[:REQUESTS]:
        events.clear()
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        infer(*batch)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        ms = {name: s.elapsed_time(e) for name, (s, e) in events.items()}
        ms["parse+nms"] = events["forward"][1].elapsed_time(end)
        ms["request"] = start.elapsed_time(end)
        for name, t in ms.items():
            per_stage.setdefault(name, []).append(t)
    for h in handles:
        h.remove()
    print(f"host wall per request ms: {[round(t, 3) for t in walls]}")
    print(f"stage (event ms, median of {REQUESTS}):")
    for name, ts in per_stage.items():
        print(f"  {name:26s} {statistics.median(ts):9.3f}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[:PROFILED]:
            infer(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    print(f"profiled window: {PROFILED} requests, host wall "
          f"{wall:.3f} ms")
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=25))
    print_trace(prof, trace_path, card, f"{PROFILED} requests")


def profile_train(card: str, trace_path: Path) -> None:
    cfg = train_config(str(trace_path.parent / "ckpt"))
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg)
    optimizer = train_lib.make_optimizer(cfg.train, 8, model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1234)
    bn_m = train_lib.bn_momentum_at(cfg.train, 0)
    model.train()

    def step(marks=None):
        """One train step (train_lib.make_detector_steps' body), with a
        CUDA event recorded at each seam if `marks` is a list."""
        def mark():
            if marks is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)
        mark()
        batch = synthetic_detection_batch(
            gen, TRAIN_B, TRAIN_N, cfg.model.num_classes,
            cfg.data.max_boxes, vote_candidates=cfg.data.vote_candidates)
        mark()
        optimizer.zero_grad()
        loss, _ = train_lib.detector_loss(model, cfg, batch, bn_m)
        mark()
        loss.backward()
        mark()
        optimizer.step()
        mark()

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    events, handles = hook_events(stage_modules(model))
    walls, per_stage = [], {}
    for _ in range(REQUESTS):
        events.clear()
        marks: list = []
        t0 = time.perf_counter()
        step(marks)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        ms = {name: s.elapsed_time(e) for name, (s, e) in events.items()}
        for name, (a, b) in {"batch": (0, 1), "forward+loss": (1, 2),
                             "backward": (2, 3), "optimizer": (3, 4),
                             "step": (0, 4)}.items():
            ms[name] = marks[a].elapsed_time(marks[b])
        for name, t in ms.items():
            per_stage.setdefault(name, []).append(t)
    for h in handles:
        h.remove()
    print(f"host wall per step ms: {[round(t, 3) for t in walls]}")
    print(f"stage (event ms, median of {REQUESTS}; forward stages are "
          f"inside forward+loss):")
    for name, ts in per_stage.items():
        print(f"  {name:26s} {statistics.median(ts):9.3f}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    print(f"profiled window: {PROFILED} train steps, host wall "
          f"{wall:.3f} ms")
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=25))
    trace = print_trace(prof, trace_path, card, f"{PROFILED} train steps")
    kernels = kernel_times(trace)
    total = sum(us for _, us, _ in kernels)
    print(f"kernels by device time over {PROFILED} steps "
          f"({total / 1e3:.3f} ms):")
    for name, us, n in kernels[:20]:
        print(f"  {us / 1e3:9.3f} ms {n:6d}x  {name[:110]}")
    gemms = [k for k in kernels if is_gemm(k[0])]
    print(f"GEMM kernels ({sum(us for _, us, _ in gemms) / 1e3:.3f} ms, "
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}):")
    for name, us, n in gemms:
        print(f"  {us / 1e3:9.3f} ms {n:6d}x  {name[:160]}")


def profile_eval(card: str, trace_path: Path) -> None:
    work = trace_path.parent / "outdoor"
    shutil.rmtree(work, ignore_errors=True)
    outdoor = prepare_outdoor(work)
    cfg = eval_config(outdoor["sweep"], outdoor["ckpt"])
    train_lib.apply_runtime_config(cfg)
    dataset = get_dataset(cfg)
    batch = next(dataset.val_batches(np.random.default_rng(0), EVAL_B))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    model = build_detector(cfg, dataset.mean_sizes)
    train_lib.restore_checkpoint(cfg.train.ckpt_dir, model, None,
                                 for_eval=True)
    eval_step = train_lib.make_detector_eval_step(model, cfg)

    def run(marks=None):
        """One batch's eval step and parse, with CUDA events at the seams
        if `marks` is a list."""
        def mark():
            if marks is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)
        mark()
        ep, _ = eval_step(batch)
        mark()
        parse_predictions(ep, model.mean_sizes, cfg.model.num_heading_bins,
                          cfg.eval)
        mark()

    for _ in range(WARMUP):
        run()
    torch.cuda.synchronize()
    events, handles = hook_events(stage_modules(model))
    walls, per_stage = [], {}
    for _ in range(REQUESTS):
        events.clear()
        marks: list = []
        t0 = time.perf_counter()
        run(marks)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        ms = {name: s.elapsed_time(e) for name, (s, e) in events.items()}
        for name, (a, b) in {"eval step": (0, 1), "parse+nms": (1, 2),
                             "batch": (0, 2)}.items():
            ms[name] = marks[a].elapsed_time(marks[b])
        for name, t in ms.items():
            per_stage.setdefault(name, []).append(t)
    for h in handles:
        h.remove()
    print(f"host wall per eval batch ms: {[round(t, 3) for t in walls]}")
    print(f"stage (event ms, median of {REQUESTS}; forward stages are "
          f"inside the eval step):")
    for name, ts in per_stage.items():
        print(f"  {name:26s} {statistics.median(ts):9.3f}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    print(f"profiled window: {PROFILED} eval batches, host wall "
          f"{wall:.3f} ms")
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=25))
    trace = print_trace(prof, trace_path, card, f"{PROFILED} eval batches")
    kernels = kernel_times(trace)
    print(f"kernels by device time over {PROFILED} batches "
          f"({sum(us for _, us, _ in kernels) / 1e3:.3f} ms):")
    for name, us, n in kernels[:20]:
        print(f"  {us / 1e3:9.3f} ms {n:6d}x  {name[:110]}")
    shutil.rmtree(work, ignore_errors=True)


def fps_cases() -> list[tuple[str, str, int, int, int]]:
    """(path, call, B, N, M) of the FPS calls of one request, train step and
    eval batch, then one config-#4 scene's B2 call."""
    cases = [(path, name, b, n1 if name == "sa1" else n, m)
             for path, b, n1 in (("serve", B, N), ("train", TRAIN_B, TRAIN_N),
                                 ("eval4", EVAL_B, EVAL_N))
             for name, n, m in FPS_SHAPES]
    return cases + [("eval4", "scene", 1, SCENE_N, EVAL_N)]


def fps_shapes(b: int, n: int, sms: int) -> list:
    """Every launch shape worth timing for b clouds of n points: at each
    cluster size of 1, 2, 4, 8, 12, 16 that fits the card, each register
    tier with the fewest threads that cover n, or the memory tier where
    none does."""
    shapes = []
    for c in sorted({1, 2, 4, 8, 12, 16} & set(range(1, sms // b + 1)),
                    reverse=True):
        per_cta = -(-n // c)
        tiers = [cuda_fps.Plan(c, 32 * -(-per_cta // (32 * p)), p)
                 for p in cuda_fps.REGISTER_TIERS]
        tiers = [t for t in tiers
                 if t.threads <= cuda_fps.REGISTER_TIERS[t.points]]
        shapes += tiers or [cuda_fps.Plan(c, cuda_fps.MAX_THREADS, 0)]
    return shapes


def profile_fps(card: str) -> None:
    """Each main-path FPS call on seeded uniform clouds (the scene with a
    masked tail, as the loader pads it), launched as plan() chooses (the C
    entry may step down its candidates) and then forced to each shape of
    fps_shapes(): exact against the plain version, then ms and us a round
    by CUDA events."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    for path, name, b, n, m in fps_cases():
        xyz = torch.empty(b, n, 3, device="cuda").uniform_(-3.0, 3.0,
                                                           generator=gen)
        mask = None
        if name == "scene":
            mask = torch.ones(b, n, dtype=torch.bool, device="cuda")
            mask[:, n - 2000:] = False
        want = plain_fps(xyz, m, mask=mask)
        chosen = cuda_fps.plan(b, n, sms)
        print(f"{path} {name} [{b},{n}]->{m}: plan() {chosen[0]} "
              f"({len(chosen)} candidates)")
        for plans in [None] + [[s] for s in fps_shapes(b, n, sms)]:
            require_equal(f"fps {path} {name} {plans}",
                          cuda_fps.fps_batched(xyz, m, mask, plans), want)
            used = cuda_fps.last_plan
            ms = cuda_ms(lambda: cuda_fps.fps_batched(xyz, m, mask, plans), 5)
            print(f"  {plan_text(used):40s} {ms:9.3f} ms "
                  f"{ms * 1e3 / (m - 1):7.3f} us/round  equal"
                  f"{'  <- plan(), as launched' if plans is None else ''}")
    print(f"on {card}")


def bq_shapes() -> list:
    """Every launch shape of the scan: 4, 8 or 16 warps a block, each
    template instance (centers a warp, loads)."""
    return [cuda_bq.Plan(w, c, shared) for shared in (False, True)
            for c in cuda_bq.CENTERS for w in (4, 8, 16)]


def time_bq_shapes(label: str, want, run) -> None:
    """run(launch) at plan()'s shape (launch None) and at each of
    bq_shapes(): exactly `want`, then ms by CUDA events, one line each."""
    for launch in [None] + bq_shapes():
        got = run(launch)
        require_equal(f"{label} {launch} idx", got[0], want[0])
        require_equal(f"{label} {launch} cnt", got[1], want[1])
        used = cuda_bq.last_plan
        ms = cuda_ms(lambda: run(launch), 10)
        print(f"  {str(used):40s} {ms:9.3f} ms  equal"
              f"{'  <- plan()' if launch is None else ''}")


def profile_ball_query(card: str, work: Path) -> None:
    """Each main-path ball-query call on its recorded inputs, exact, at
    every shape of the scan; then the three SA1 calls through the sorted
    tier: the codes and sorts, the scan at every shape, the whole call."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    shutil.rmtree(work, ignore_errors=True)
    recorded = {"serve": capture_request(),
                "train": capture_train_step(gen),
                "eval4": capture_eval_batch(prepare_outdoor(work))[1]}
    names = [name for name, *_ in BQ_SHAPES]
    for path, calls in recorded.items():
        for name, (args, kw) in zip(names, calls["ball_query"]):
            xyz, centers, r, k = args
            mask = kw.get("mask")
            (b, n), m = xyz.shape[:2], centers.shape[1]
            print(f"{path} {name} [{b},{n}] M={m} r={r:g} K={k}: plan() "
                  f"{cuda_bq.plan(b, n, m, k, sms)}")
            time_bq_shapes(f"ball_query {path} {name}",
                           plain_bq(xyz, centers, r, k, mask=mask),
                           lambda launch: cuda_bq.ball_query(
                               xyz, centers, r, k, mask, launch=launch))
    for path, calls in recorded.items():
        (xyz, centers, r, k), kw = calls["ball_query"][0]
        mask = kw.get("mask")
        with ops.use_impl("plain"):
            want = sorted_bq.sorted_ball_query(xyz, centers, r, k, mask=mask)
        perm, perm_c = sorted_bq.z_order(xyz, centers, mask)
        whole = cuda_ms(lambda: sorted_bq.sorted_ball_query(
            xyz, centers, r, k, mask=mask), 10)
        keys = cuda_ms(lambda: sorted_bq.z_order(xyz, centers, mask), 10)
        codes = cuda_ms(lambda: cuda_bq.morton_codes(xyz, centers, mask), 10)
        print(f"{path} sa1 sorted [{xyz.shape[0]},{xyz.shape[1]}]: whole "
              f"call {whole:.3f} ms; codes + sorts {keys:.3f} ms (codes "
              f"{codes:.3f}); the scan with map-back:")
        time_bq_shapes(f"sorted {path} sa1", want,
                       lambda launch: cuda_bq.ball_query(
                           xyz, centers, r, k, mask, perm=perm,
                           perm_c=perm_c, launch=launch))
    shutil.rmtree(work, ignore_errors=True)
    print(f"on {card}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="profile the config-#3 train step instead")
    mode.add_argument("--eval", action="store_true",
                      help="profile a config-#4 eval batch instead")
    mode.add_argument("--fps", action="store_true",
                      help="time the FPS kernel per main-path call and "
                           "cluster size instead")
    mode.add_argument("--ball-query", action="store_true",
                      help="time the ball-query kernel per main-path call "
                           "and launch shape instead")
    ap.add_argument("--trace", type=Path, default=None)
    args = ap.parse_args()
    card = phase_device()
    if args.fps:
        profile_fps(card)
    elif args.ball_query:
        profile_ball_query(card, Path("build/profile/outdoor"))
    elif args.train:
        profile_train(card, args.trace or Path("build/profile/train_trace.json"))
    elif args.eval:
        profile_eval(card, args.trace or Path("build/profile/eval_trace.json"))
    else:
        profile_serve(card,
                      args.trace or Path("build/profile/request_trace.json"))


if __name__ == "__main__":
    main()
