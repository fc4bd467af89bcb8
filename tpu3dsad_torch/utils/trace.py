"""Spans at the port's layer boundaries: where a call of the program spends
its time, on the host's clock and on the card's.

    from tpu3dsad_torch.utils import trace
    trace.enable()
    ...  # serve, train or evaluate
    torch.cuda.synchronize()
    trace.write("spans.jsonl", trace.collect())

Off (the default), `span(name)` is one test of a module flag and returns a
shared no-op context: no CUDA event, no profiler range, no allocation and
no device op. On, each span records

  * its name, its parent span's name and the id of its root (the spans of
    one call of the program share it);
  * its host start and end (time.perf_counter_ns);
  * while torch.profiler runs, a range of the same name, so that in a
    profiled window the program's layers sit on the device trace's own
    clock (outside one, a range would cost ~10 us a span for nothing);
  * on the card, a pair of CUDA events made with `external=True`, so that
    a CUDA-graph capture keeps them as event-record nodes.

Spans sit at layer boundaries only, never inside a per-element loop (the
NMS walk's steps). They are no-ops while torch.compile or torch.export
traces the program, so an exported program is the same with the tracer on
or off.

The tracer never synchronises. `collect()` returns the records made since
the last collect and clears them; it reads a span's device ms where its
end event has completed, so the caller synchronises first.

A CUDA graph captured inside `captured()` keeps the event pairs of the
spans opened during the capture; each replay records them again. The
graph's owner calls `Captured.replayed()` after its replays and
`Captured.sample()` before its next ones: a sample, also taken by
`collect()`, adds the last replay's device ms to the records (phase
"replay", one root id a replay) once Event.query() says they are done, so
nothing waits. Records made while capturing carry phase "capture": their
host times are the capture's, not a step's. A graph captured with the
tracer off holds no event node.

Record keys: name, parent, root, phase ("eager", "capture" or "replay"),
start_ns, end_ns (host; None for a replay) and device_ms (None off the
card, during a capture, or where the end event had not completed).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import time
import weakref

import torch

_ON = False
_CUDA = False  # the spans record CUDA events (the tracer is on, on a card)
_NOOP = contextlib.nullcontext()
_records: list = []  # open and closed spans, and replay samples (dicts)
_roots = itertools.count()
_stack: list = []  # the open spans, innermost last
_capture = None  # the Captured of the graph capture in progress
_graphs: "weakref.WeakSet[Captured]" = weakref.WeakSet()


def enable(on: bool = True) -> None:
    """Turn the tracer on (CUDA events where torch finds a card) or off."""
    global _ON, _CUDA
    _ON = bool(on)
    _CUDA = _ON and torch.cuda.is_available()


def span(name: str):
    """A context that records one span named `name` while the tracer is
    on; the shared no-op context while it is off."""
    if not _ON or torch.compiler.is_compiling():
        return _NOOP
    return _Span(name)


class _Span:
    __slots__ = ("name", "parent", "root", "phase", "start_ns", "end_ns",
                 "begin", "end", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.parent = _stack[-1] if _stack else None
        self.root = (next(_roots) if self.parent is None
                     else self.parent.root)
        self.phase = "eager" if _capture is None else "capture"
        self.end_ns = None
        self.start_ns = time.perf_counter_ns()
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.begin = self.end = None
        if _CUDA:
            self.begin = torch.cuda.Event(enable_timing=True, external=True)
            self.end = torch.cuda.Event(enable_timing=True, external=True)
            self.begin.record()
            if _capture is not None:
                _capture.spans.append(self)
        _stack.append(self)
        _records.append(self)
        return self

    def __exit__(self, *exc):
        if self.end is not None:
            self.end.record()
        if self.range is not None:
            self.range.__exit__(*exc)
            self.range = None  # the profiler's handle is not kept
        _stack.pop()
        self.end_ns = time.perf_counter_ns()
        return False

    def record(self) -> dict:
        ms = None
        if (self.end is not None and self.phase == "eager"
                and self.end.query()):
            ms = self.begin.elapsed_time(self.end)
        return {"name": self.name,
                "parent": None if self.parent is None else self.parent.name,
                "root": self.root, "phase": self.phase,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "device_ms": ms}


class Captured:
    """The spans opened while one CUDA graph was captured (`captured()`):
    their event pairs are nodes of the graph, recorded again by every
    replay."""

    def __init__(self):
        self.spans: list[_Span] = []
        self.pending = False  # a replay since the last sample

    def replayed(self) -> None:
        """Note that the graph was replayed (call after the replays)."""
        self.pending = True

    def sample(self) -> None:
        """Add the last replay's device ms of each span to the records,
        under one new root id, where the tracer is on, a replay came since
        the last sample and its events have completed; else nothing. Never
        waits: call it before the graph is replayed again."""
        if not (_ON and self.pending and self.spans) or not all(
                s.end.query() for s in self.spans):
            return
        root = next(_roots)
        inside = {id(s) for s in self.spans}
        for s in self.spans:
            parent = s.parent if s.parent is not None \
                and id(s.parent) in inside else None
            _records.append({
                "name": s.name,
                "parent": None if parent is None else parent.name,
                "root": root, "phase": "replay", "start_ns": None,
                "end_ns": None,
                "device_ms": s.begin.elapsed_time(s.end)})
        self.pending = False


@contextlib.contextmanager
def captured():
    """Around a CUDA-graph capture: yields the Captured that holds the spans
    opened inside it (none where the tracer is off or finds no card)."""
    global _capture
    cap, outer = Captured(), _capture
    _capture = cap
    try:
        yield cap
    finally:
        _capture = outer
    if cap.spans:
        _graphs.add(cap)


def collect() -> list[dict]:
    """The records made since the last collect, in the order their spans
    opened (a graph's replay samples where they were taken), then cleared.
    Samples every graph captured with spans first. Spans still open stay
    for the next collect."""
    for cap in list(_graphs):
        cap.sample()
    out, still_open = [], []
    for r in _records:
        if isinstance(r, dict):
            out.append(r)
        elif r.end_ns is None:
            still_open.append(r)
        else:
            out.append(r.record())
    _records[:] = still_open
    return out


def times(records: list, clock: str = "device") -> dict[str, list[float]]:
    """{span name: [ms, one a record]} on the card's clock ("device":
    records without device ms left out) or the host's ("host": replay
    samples have none; a capture's records hold the capture's host times,
    so leave them out of `records` where they are not wanted)."""
    out: dict[str, list[float]] = {}
    for r in records:
        if clock == "device":
            ms = r["device_ms"]
        elif r["start_ns"] is not None:
            ms = (r["end_ns"] - r["start_ns"]) / 1e6
        else:
            ms = None
        if ms is not None:
            out.setdefault(r["name"], []).append(ms)
    return out


def write(path, records: list) -> None:
    """`records` as JSON lines at `path`."""
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
