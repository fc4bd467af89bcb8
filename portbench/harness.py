"""The benchmark's general part: it finds a cell's workload, configuration,
traffic driver and per-layer metric readers by the names in
BENCHMARK.json, runs the traffic driver, reads the profiler's trace of a
traced run, decides `correct` and prints the result.

Each cell is one file `workloads/<cell>.json` naming its configuration
(`configs/<config>.json`), its driver (`drivers/<driver>.py`) and its
traffic parameters; each per-layer metric is one reader
`metrics/<metric>.py` with `read(trace) -> float | None`. A later cell,
configuration or metric is new files and new entries in BENCHMARK.json.

A driver's `run(ctx)` builds the program from the configuration, makes
its inputs and weights from the seed, warms up, calls `ctx.setup_done()`,
hands its traffic loop to `measure` and returns a `Result`. `measure`
runs the loop for `ctx.seconds` (the measured window, never under the
profiler); a traced run then runs the same loop for the workload's
`trace_seconds` more under torch.profiler, for what only a trace shows
(kernel times, launches, the device's busy time). The harness reads the peak memory, drops the
driver's program state, runs `Result.check` (the plain reference against
what the timed path produced), then checks that nothing of JAX was
loaded, and prints the result line last on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import gzip
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from portbench.counts import PEAK_FLOPS, bound_seconds, forward_flops

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu3dsad")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Check:
    """One number compared with the plain reference, and its limit: the
    run is correct where value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclasses.dataclass
class Result:
    attempted: int
    failed: int
    metrics: dict  # end-to-end values by name (trace 0)
    check: Callable[[], list]  # -> [Check], run once the state is freed
    trace: "Trace | None" = None  # the traced window (trace 1)


@dataclasses.dataclass
class Trace:
    """What a traced window shows, for the per-layer readers."""

    window_s: float
    busy_s: float
    kernels: dict  # kernel name -> (device seconds, launches)
    device_ops: list  # [(name, device seconds)] of every device op, most first
    idle_gaps: list  # [(host range, idle seconds)], longest first
    units: int  # requests or train steps completed in the traced window
    scenes: int  # scenes of those requests or steps
    scenes_per_s: float  # the measured (untraced) window's scenes a second
    spans: dict  # span name -> [device ms, one a unit of the measured window]
    model: dict  # the configuration's model section
    batch: int
    points: int  # the points of a cloud as the program gets it
    precision: str  # the MLP products' precision that torch's flags select

    def idle_share(self) -> float | None:
        """Percent of the traced window (wall time, from its first host
        range to the end of its last device op) in which no operation ran
        on the device."""
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def mfu(self, passes: int) -> float | None:
        """Percent of the card's peak, at the precision torch's flags
        select, that `passes` x the forward's matmul FLOPs a scene reach at
        the measured window's scenes a second."""
        if not self.scenes_per_s:
            return None
        flops = passes * forward_flops(self.model) * self.scenes_per_s
        return 100.0 * flops / PEAK_FLOPS[self.precision]

    def roofline(self, calls: list, cost, timed: tuple,
                 counted: str) -> float | None:
        """Percent of the device time of the kernels named by `timed` that
        the least time of `calls` (each call's cost(call) -> (ops, bytes),
        once a unit) takes; None where the launches of the kernel named
        `counted` are not one a call a unit."""
        secs, _ = self.kernel(*timed)
        _, launches = self.kernel(counted)
        if not secs or launches != len(calls) * self.units:
            return None
        return 100.0 * bound_seconds(cost(c) for c in calls) \
            * self.units / secs

    def kernel(self, *parts: str) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds one
        of `parts`."""
        secs, n = 0.0, 0
        for name, (s, c) in self.kernels.items():
            if any(p in name for p in parts):
                secs, n = secs + s, n + c
        return secs, n


class Context:
    """What a driver gets: the cell, its configuration and seed, the
    device, and the clock of the run."""

    def __init__(self, root: Path, name: str, seed: int, seconds: float,
                 trace: bool, device: torch.device, start: float):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.cell = cells[name]
        self.bench = bench
        self.root = root
        self.name = name
        self.workload = json.loads(
            (HERE / "workloads" / f"{name}.json").read_text())
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads(
            (root / configs[self.cell["config"]]["file"]).read_text())
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.start = start
        self.setup_s = None
        self.work_dir = root / "build" / "portbench"

    # ------------------------------------------------------------ set-up

    def port_config(self):
        """The program's Config of this configuration file."""
        from tpu3dsad_torch.config import Config

        cfg = Config()
        sections = {}
        for section in ("model", "data", "train", "eval"):
            values = {k: _tuples(v)
                      for k, v in self.config.get(section, {}).items()}
            sections[section] = dataclasses.replace(getattr(cfg, section),
                                                    **values)
        return dataclasses.replace(cfg, **sections)

    def matmul(self) -> str:
        """The precision of the MLP products the configuration states."""
        return "tf32" if self.config["train"]["bf16_matmul"] else "fp32"

    def weights(self, model) -> dict:
        """weights.draw for every floating state of `model`, loaded into
        it; the returned tensors are the benchmark's own copy, for the
        reference."""
        from portbench import weights

        state = {n: tuple(v.shape) for n, v in model.state_dict().items()
                 if v.is_floating_point()}
        out = weights.draw(state, self.seed, self.device)
        model.load_state_dict(out)
        return out

    def setup_done(self) -> None:
        """Mark the end of set-up: the first timed request or step
        follows."""
        self.setup_s = time.perf_counter() - self.start

    @contextlib.contextmanager
    def traced(self, holder: dict):
        """torch.profiler (host and device) around a traced window;
        `holder["events"]` gets the trace's events. A no-op in an untraced
        run."""
        if not self.trace:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        path = self.work_dir / "trace.json.gz"
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(str(path))
        with gzip.open(path, "rt") as f:
            holder["events"] = json.load(f)["traceEvents"]
        path.unlink()


def measure(ctx: Context, loop: Callable[[float], dict],
            spans=None) -> tuple[dict, "Trace | None"]:
    """Run the traffic loop for the measured window, then, in a traced
    run, for the workload's trace_seconds under the profiler.

    `loop(seconds)` drives the cell's traffic for `seconds` and returns at
    least {"units", "scenes", "elapsed"} (requests or steps completed, their
    scenes, the host seconds they took). `spans` (program.Spans, or None)
    gives the device ms by span of the measured window's units. Returns
    (the measured window's loop result, the Trace of the traced window or
    None)."""
    window = loop(ctx.seconds)
    if not ctx.trace:
        return window, None
    span_ms = spans.ms() if spans is not None else {}
    events: dict = {}
    with ctx.traced(events):
        with record_function("window"):
            traced = loop(ctx.workload["trace_seconds"])
    trace = read_trace(events["events"], traced["units"], traced["scenes"],
                       span_ms, ctx, window["scenes"] / window["elapsed"])
    return window, trace


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


# ------------------------------------------------------------ trace reading


def busy_seconds(events: list, t0: float, t1: float) -> float:
    """Seconds in [t0, t1] (us) in which some device op ran: the union of
    the device intervals, clipped to the window."""
    spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                   for e in events if e.get("cat") in DEVICE_CATS)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6


def idle_gaps(events: list, t0: float, t1: float, top: int = 10) -> list:
    """The longest idle stretches of the device in [t0, t1] (us), each
    named by the innermost host range (a record_function of the traffic
    driver) open at its start: [(name, seconds)]."""
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in DEVICE_CATS)
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and not e["name"].startswith("ProfilerStep"))
    gaps, last = [], t0
    for s, e in dev:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if t1 > last:
        gaps.append((last, t1))
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        inner = [r for r in ranges if r[0] <= s < r[1]]
        name = (min(inner, key=lambda r: r[1] - r[0])[2] if inner
                else "outside the host ranges")
        named.append((name, (e - s) / 1e6))
    return named


def short_name(name: str, width: int = 160) -> str:
    """A device op's name without its argument list, cut to `width`."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):  # the first "(" outside template brackets
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:width]


def read_trace(events: list, units: int, scenes: int, spans: dict,
               ctx: Context, scenes_per_s: float) -> Trace:
    """A Trace of the profiler's events over the traffic driver's range
    "window", extended to the end of the last device op that started in
    it."""
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "window"]
    if not marks:
        raise RuntimeError("the trace holds no 'window' range")
    t0, t1 = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
    # the device may finish the window's work after the host range ends
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e["ts"] + e["dur"] > t0]
    t1 = max([t1] + [e["ts"] + e["dur"] for e in dev])
    kernels, ops = {}, {}
    for e in dev:
        name = short_name(e["name"])
        if e["cat"] == "kernel":
            s, n = kernels.get(name, (0.0, 0))
            kernels[name] = (s + e["dur"] / 1e6, n + 1)
        ops[name] = ops.get(name, 0.0) + e["dur"] / 1e6
    return Trace(
        window_s=(t1 - t0) / 1e6,
        busy_s=busy_seconds(dev, t0, t1),
        kernels=kernels,
        device_ops=sorted(ops.items(), key=lambda kv: -kv[1]),
        idle_gaps=idle_gaps(events, t0, t1),
        units=units, scenes=scenes, scenes_per_s=scenes_per_s, spans=spans,
        model=ctx.config["model"], batch=ctx.workload.get("batch", 1),
        points=ctx.workload["budget"],
        precision=("tf32" if torch.backends.cuda.matmul.allow_tf32
                   else "fp32"))


# ------------------------------------------------------------ the run


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """The reader module of per-layer metric `name` (metrics/<name>.py)."""
    return _load(HERE / "metrics" / f"{name}.py",
                 "portbench_metric_" + name.replace(".", "_"))


def _applies(entry: dict, cell: str, reported: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") in reported


def _device_info(ctx: Context, count: int) -> dict:
    if ctx.device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(ctx.device),
                "count": count,
                "memory_peak_bytes": int(
                    torch.cuda.max_memory_allocated(ctx.device))}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def main(argv=None, device: str | None = None, start: float | None = None):
    """Run one cell and print its result; returns the exit code. device
    None looks for the card and refuses to run without enough of them;
    a device given (the tests' "cpu") skips that look."""
    start = time.perf_counter() if start is None else start
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = HERE.parent
    if device is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
        chips = {w["name"]: w["chips"]
                 for w in bench["workloads"]}.get(args.workload, 1)
        found = (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)
        if found < chips:
            print(f"needs {chips} CUDA device(s); found {found}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    ctx = Context(root, args.workload, args.seed, args.seconds,
                  bool(args.trace), torch.device(device), start)
    driver = _load(HERE / "drivers" / f"{ctx.workload['driver']}.py",
                   f"portbench_driver_{ctx.workload['driver']}")
    result = driver.run(ctx)
    info = _device_info(ctx, ctx.cell["chips"])
    del driver
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    checks = result.check()
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"refused: the run loaded {loaded}", file=sys.stderr)
        return 3

    e2e = [m for m in ctx.bench["end_to_end"]
           if "workloads" not in m or ctx.name in m["workloads"]]
    metrics = {}
    if not ctx.trace:
        values = dict(result.metrics, setup_s=ctx.setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        reported = {m["name"] for m in e2e}
        for m in ctx.bench["per_layer"]:
            if not _applies(m, ctx.name, reported):
                continue
            value = metric_reader(m["name"]).read(result.trace)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        info["busy_s"] = result.trace.busy_s
        info["window_s"] = result.trace.window_s
    correct = result.failed == 0 and all(c.ok for c in checks)
    line = {"correct": correct, "attempted": result.attempted,
            "failed": result.failed, "metrics": metrics, "device": info}
    if ctx.trace:
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in result.trace.device_ops[:10]],
            "idle_gaps": [[n, s] for n, s in result.trace.idle_gaps[:10]]}
    line["checks"] = {c.name: {"value": c.value if np.isfinite(c.value)
                               else None, "limit": c.limit}
                      for c in checks}
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r})"
              f"{'' if c.ok else ' FAILED'}", file=sys.stderr)
    print(json.dumps(line))
    return 0
