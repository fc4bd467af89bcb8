#!/usr/bin/env python3
"""Where one request's time goes in the PyTorch / CUDA port, on one GPU.

    python3 profile_port.py [--trace PATH]

Drives the program of chip_smoke.py (BASELINE config #5: 32 scenes x 20480
points, seeded random weights, served through serving.build_inference_fn)
and prints:

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
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import build_server, make_requests, phase_device

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", type=Path,
                    default=Path("build/profile/request_trace.json"))
    args = ap.parse_args()

    card = phase_device()
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
    args.trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(args.trace))
    trace = json.loads(args.trace.read_text())["traceEvents"]
    n, busy, span = busy_share(trace)
    print(f"kernels: {n}; busy {busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms "
          f"kernel span = {busy / span:.3f} busy share; {card}")


if __name__ == "__main__":
    main()
