#!/usr/bin/env python3
"""One cell of the benchmark (portbench/) run with the port's tracer on,
and the program's spans of its measured window read out:

    python3 trace_cells.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--tracer on|off] [--out DIR]

It runs portbench's `harness.main` as portbench/run.py does and prints the
same result line on stdout, with three differences made in memory (no
file of portbench/ is edited):

  * the tracer (tpu3dsad_torch/utils/trace.py) is turned on before the
    cell's set-up, so a CUDA graph captured there keeps its step's spans
    as event nodes (`--tracer off` leaves it off, for the end-to-end cost
    of tracing compared in one call);
  * the records of the measured window (the traffic loop's first call)
    are collected after it, the card synchronised, and written to
    DIR/<cell>-<seed>-t<trace>-<tracer>.jsonl (trace.write's JSON lines);
  * in a traced run (--trace 1), the kernel-launch runtime calls of the
    profiled window are counted by the innermost program range they were
    made in (the spans are the profiler's ranges there).

Last, one line "SPANS {...}" on stderr: the mean device and host ms of
each span a record, the records of each, the garbage collector's passes
during the window ({generation: [passes, longest ms, total ms]}), the
share of train.step's device ms that its five children cover (least and
most over the steps), the launches by range, and `readings`: the numbers
that the proposed per-layer metrics of PERF.md §7 would read, each the
mean a record of the window where the cell has such spans:

  backbone_ms       device ms of detector.backbone   (sweep.backbone_ms)
  nms_ms            device ms of parse.nms            (sweep.nms_ms)
  prepare_ms        host ms of serve.prepare          (latency.prepare_ms)
  detections_ms     host ms of serve.detections       (latency.detections_ms)
  forward_ms, backward_ms, optimizer_ms
                    device ms of train.forward, .backward, .optimizer
                    (train.k8.*: replayed steps at k = 8)
  host_step_ms      host ms of train.step             (train.k1.host_step_ms)
  nms_launches_per_request
                    launch calls inside parse.nms (its IoU's range
                    parse.iou included) over its calls, profiled window
                    (latency.nms_launches_per_request)

and `oriented_iou`, where the window ran oriented NMS: the oriented IoU
kernel's launches in the measured window (the wrapper's counter,
ops/cuda/iou.py).

Needs a CUDA device, as the harness does (it exits 2 without one).
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from tpu3dsad_torch.ops.cuda import iou as cuda_iou  # noqa: E402
from tpu3dsad_torch.utils import trace  # noqa: E402

# the program's ranges in a profiler trace (portbench's traffic drivers'
# own ranges are left out)
PREFIXES = ("serve.", "detector.", "backbone.", "parse.", "train.")
STEP_PARTS = ("train.augment", "train.forward", "train.loss",
              "train.backward", "train.optimizer")
READINGS = (  # (reading, span, clock)
    ("backbone_ms", "detector.backbone", "device"),
    ("nms_ms", "parse.nms", "device"),
    ("prepare_ms", "serve.prepare", "host"),
    ("detections_ms", "serve.detections", "host"),
    ("forward_ms", "train.forward", "device"),
    ("backward_ms", "train.backward", "device"),
    ("optimizer_ms", "train.optimizer", "device"),
    ("host_step_ms", "train.step", "host"),
)


def launches_by_range(events: list) -> tuple[Counter, Counter]:
    """(kernel-launch runtime calls by the innermost program range they
    fall in, "(no program range)" outside all; calls of each range) of a
    chrome trace's events. The ranges of one host thread nest, so a stack
    walked in time order finds the innermost."""
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                     for e in events if e.get("cat") == "user_annotation"
                     and e["name"].startswith(PREFIXES)),
                    key=lambda r: (r[0], -r[1]))
    calls = Counter(name for _, _, name in ranges)
    starts = sorted(e["ts"] for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "LaunchKernel" in e["name"])
    counts: Counter = Counter()
    stack, i = [], 0
    for t in starts:
        while i < len(ranges) and ranges[i][0] <= t:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        counts[stack[-1][2] if stack else "(no program range)"] += 1
    return counts, calls


def step_cover(records: list) -> list | None:
    """[least, most] over the steps of the records of the share of
    train.step's device ms that its five children take; None without."""
    by_root: dict = {}
    for r in records:
        if r["device_ms"] is not None:
            by_root.setdefault(r["root"], {})[r["name"]] = r["device_ms"]
    cover = [sum(ms.get(n, 0.0) for n in STEP_PARTS) / ms["train.step"]
             for ms in by_root.values() if ms.get("train.step")]
    return [min(cover), max(cover)] if cover else None


def _mean(xs):
    return statistics.fmean(xs) if xs else None


class Window:
    """What the measured window left: the tracer's records and units, the
    collector's passes, and (traced) the launches by program range."""

    def __init__(self):
        self.records: list = []
        self.units = None
        self.gc = None
        self.launches = self.range_calls = None
        self.iou = None
        self._pauses: list = []  # (generation, seconds) of each pass
        self._gc_t0 = 0.0

    def gc_watch(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self._pauses.append((info["generation"],
                                 time.perf_counter() - self._gc_t0))

    def wrap_measure(self, measure):
        """harness.measure, with the loop's first call (the measured
        window) bracketed by collects."""
        def wrapped(ctx, loop, spans=None):
            first = [True]

            def window_loop(seconds):
                if not first[0]:
                    return loop(seconds)
                first[0] = False
                trace.collect()  # set-up's records
                iou = cuda_iou.launches
                self._pauses.clear()
                out = loop(seconds)
                pauses = list(self._pauses)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.records = trace.collect()
                if cuda_iou.launches > iou:
                    self.iou = {"launches": cuda_iou.launches - iou}
                self.units = out["units"]
                self.gc = {}
                for g in (0, 1, 2):
                    ts = [s for q, s in pauses if q == g]
                    self.gc[g] = [len(ts), round(1e3 * max(ts, default=0.0),
                                                 3), round(1e3 * sum(ts), 3)]
                return out

            return measure(ctx, window_loop, spans)
        return wrapped

    def wrap_read_trace(self, read_trace):
        def wrapped(events, *args, **kwargs):
            self.launches, self.range_calls = launches_by_range(events)
            return read_trace(events, *args, **kwargs)
        return wrapped

    def summary(self) -> dict:
        records = [r for r in self.records if r["phase"] != "capture"]
        spans = {"device": trace.times(records),
                 "host": trace.times(records, clock="host")}
        readings = {key: _mean(spans[clock].get(name, []))
                    for key, name, clock in READINGS}
        if self.range_calls and self.range_calls.get("parse.nms"):
            # parse.iou, the IoU's range, lies inside parse.nms
            readings["nms_launches_per_request"] = (
                (self.launches.get("parse.nms", 0)
                 + self.launches.get("parse.iou", 0))
                / self.range_calls["parse.nms"])
        return {
            "units": self.units, "gc": self.gc,
            "readings": {k: v for k, v in readings.items() if v is not None},
            "device_ms": {n: _mean(v) for n, v in spans["device"].items()},
            "host_ms": {n: _mean(v) for n, v in spans["host"].items()},
            "records": dict(Counter(r["name"] for r in records)),
            "replays": sum(1 for r in records if r["phase"] == "replay"
                           and r["name"] == "train.step"),
            "step_cover": step_cover(records),
            "oriented_iou": self.iou,
            "launches": None if self.launches is None
            else dict(self.launches),
            "range_calls": None if self.range_calls is None
            else dict(self.range_calls)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True)
    p.add_argument("--seconds", required=True)
    p.add_argument("--trace", choices=("0", "1"), default="0")
    p.add_argument("--tracer", choices=("on", "off"), default="on")
    p.add_argument("--out", type=Path, default=ROOT / "build" / "spans")
    args = p.parse_args(argv)
    # run.py's caches, set before any kernel is built
    os.environ["TRITON_CACHE_DIR"] = str(
        ROOT / "build" / "portbench" / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(
        ROOT / "build" / "portbench" / "inductor")
    window = Window()
    harness.measure = window.wrap_measure(harness.measure)
    harness.read_trace = window.wrap_read_trace(harness.read_trace)
    gc.callbacks.append(window.gc_watch)
    trace.enable(args.tracer == "on")
    rc = harness.main(["--workload", args.workload, "--seed", args.seed,
                       "--seconds", args.seconds, "--trace", args.trace],
                      start=START)
    args.out.mkdir(parents=True, exist_ok=True)
    trace.write(args.out / f"{args.workload}-{args.seed}-t{args.trace}-"
                f"{args.tracer}.jsonl", window.records)
    print("SPANS " + json.dumps({"cell": args.workload,
                                 "tracer": args.tracer, **window.summary()}),
          file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
