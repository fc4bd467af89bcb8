"""The port's tracer (tpu3dsad_torch/utils/trace.py) at the layer
boundaries of the program, on the CPU:

  * off, it makes no CUDA event and no profiler range, and the outputs are
    bitwise those of a traced run; on, a range only while torch.profiler
    runs;
  * on, a served call, an eager train step and an eager k-step block give
    the spans, parents and root ids of their tables;
  * export_detector gives the same graph with the tracer on or off;
  * collect() clears, write() round-trips, train.profile_dir writes
    spans.jsonl beside trace.json;
  * a capture's spans give per-replay device ms, sampled only where the
    replay has finished (with stand-in events on the CPU; the `card` tests
    repeat it with a captured step on a CUDA device and skip without one);
  * trace_cells.py's readings of a benchmark cell's spans: launches by
    the innermost program range, the summary of a window's records, and
    the measured window collected alone.

This file imports no JAX, so on the card it runs alone:
    python -m pytest tests/test_torch_trace.py --noconftest -m card
"""

import itertools
import json
import types

import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from tpu3dsad_torch import serving, train_lib
from tpu3dsad_torch import train as entry
from tpu3dsad_torch.config import parse_cli
from tpu3dsad_torch.data.device_pipeline import synthetic_detection_batch
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.utils import trace

import trace_cells

TINY = [
    "model.name=detector", "data.name=synthetic", "data.num_points=256",
    "data.max_boxes=8", "model.num_classes=4",
    "model.sa_npoints=(64,32,16,8)", "model.sa_nsamples=(8,8,4,4)",
    "model.sa_channels=((16,16),(16,32),(16,32),(16,32))",
    "model.fp_channels=((32,32),(32,32))", "model.seed_feat_dim=32",
    "model.num_proposals=16", "model.cluster_nsample=4",
    "train.batch_size=2", "data.device_augment=true",
]

BACKBONE = ["backbone.sa1", "backbone.sa2", "backbone.sa3", "backbone.sa4",
            "backbone.fp1", "backbone.fp2"]


def forward_spans(parent):
    """(name, parent) of the detector's spans under `parent`, in order."""
    return ([("detector.backbone", parent)]
            + [(n, "detector.backbone") for n in BACKBONE]
            + [("detector.voting", parent), ("detector.proposal", parent)])


SERVED = ([("serve.program", None)] + forward_spans("serve.program")
          + [("parse.decode", "serve.program"),
             ("parse.nms", "serve.program"), ("parse.iou", "parse.nms")])
STEP = ([("train.step", None), ("train.augment", "train.step"),
         ("train.forward", "train.step")] + forward_spans("train.forward")
        + [("train.loss", "train.step"), ("train.backward", "train.step"),
           ("train.optimizer", "train.step")])


@pytest.fixture(autouse=True)
def tracer_off():
    trace.enable(False)
    trace.collect()
    yield
    trace.enable(False)
    trace.collect()


def build(device="cpu"):
    cfg = parse_cli(TINY)
    train_lib.apply_runtime_config(cfg)
    model = SizeAdaptiveDetector(cfg.model, device=device,
                                 generator=torch.Generator().manual_seed(3))
    return cfg, model


def scenes(device="cpu"):
    gen = torch.Generator().manual_seed(0)
    pts = torch.rand(2, 256, 3, generator=gen) * 4.0
    mask = torch.ones(2, 256, dtype=torch.bool)
    mask[1, 200:] = False
    return pts.to(device), mask.to(device)


def batch(cfg, seed=1, device="cpu"):
    return synthetic_detection_batch(
        torch.Generator(device=device).manual_seed(seed), 2,
        cfg.data.num_points, cfg.model.num_classes, cfg.data.max_boxes,
        vote_candidates=cfg.data.vote_candidates)


def pairs(records):
    return [(r["name"], r["parent"]) for r in records]


def serve_and_step():
    """One served call and one train step from fixed weights: the served
    fields, then the step's loss and the parameters after it."""
    cfg, model = build()
    out = serving.build_inference_fn(cfg, model, model.mean_sizes)(*scenes())
    opt = train_lib.make_optimizer(cfg.train, 1 << 20, model.parameters())
    step = train_lib.make_detector_steps(model, opt, cfg)
    loss = step(batch(cfg), torch.Generator().manual_seed(5), 0.5)["loss"]
    return out, loss, [p.detach().clone() for p in model.parameters()]


class FakeEvent:
    """A stand-in for torch.cuda.Event on the CPU: a record takes the next
    tick of a clock; elapsed_time is the ticks between two records."""

    made = recorded = 0
    clock = itertools.count(1)

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing and external
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        FakeEvent.recorded += 1
        self.t = next(FakeEvent.clock)

    def query(self):
        return self.t is not None

    def elapsed_time(self, other):
        return float(other.t - self.t)


@pytest.fixture
def fake_card(monkeypatch):
    """The tracer on, recording FakeEvents as it would CUDA events."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    trace.enable()
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    FakeEvent.made = FakeEvent.recorded = 0
    return FakeEvent


def test_off_makes_no_event_and_no_range_and_changes_no_output(
        monkeypatch, fake_card):
    ranges = []
    inner = torch.profiler.record_function

    def counted(name, *args):
        ranges.append(name)
        return inner(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    traced = serve_and_step()  # no profiler running: no range
    spans = len(trace.collect())
    assert (fake_card.recorded, ranges) == (2 * spans, [])
    fake_card.recorded = 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        serve_and_step()
        assert fake_card.recorded == 2 * len(ranges) == 2 * spans > 0
        trace.collect()

        trace.enable(False)
        fake_card.made = fake_card.recorded = 0
        ranges[:] = []
        assert trace.span("a") is trace.span("b")  # the one shared no-op
        plain = serve_and_step()
        assert (fake_card.made, fake_card.recorded, ranges,
                trace.collect()) == (0, 0, [], [])
    for k, v in traced[0].items():
        assert torch.equal(plain[0][k], v), k
    assert torch.equal(plain[1], traced[1])
    assert all(torch.equal(a, b) for a, b in zip(plain[2], traced[2]))


def test_served_call_spans():
    cfg, model = build()
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes)
    manifest = {"batch_size": 1, "num_points": 256, "with_features": False}
    raw = np.random.default_rng(0).uniform(0, 4, (400, 3)).astype(np.float32)
    trace.enable()
    args = serving.prepare_scene_batch(raw, manifest, device="cpu")
    dets = serving.detections(infer(*args))
    trace.enable(False)
    records = trace.collect()
    assert pairs(records) == ([("serve.prepare", None)] + SERVED
                              + [("serve.detections", None),
                                 ("serve.d2h", "serve.detections")])
    roots = [r["root"] for r in records]
    # three calls: the fit, the program, the listing
    assert roots == [roots[0]] + [roots[1]] * len(SERVED) + [roots[-1]] * 2
    assert len(set(roots)) == 3
    for r in records:
        assert r["phase"] == "eager" and r["device_ms"] is None
        assert r["end_ns"] >= r["start_ns"]
    by = {r["name"]: r for r in records}
    for r in records:  # a child lies inside its parent on the host's clock
        if r["parent"]:
            p = by[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]
    assert isinstance(dets, list)


def test_eager_train_step_spans():
    cfg, model = build()
    opt = train_lib.make_optimizer(cfg.train, 1 << 20, model.parameters())
    step = train_lib.make_detector_steps(model, opt, cfg)
    trace.enable()
    step(batch(cfg), torch.Generator().manual_seed(5), 0.5)
    records = trace.collect()
    assert pairs(records) == STEP
    assert len({r["root"] for r in records}) == 1
    host = trace.times(records, clock="host")
    children = ("train.augment", "train.forward", "train.loss",
                "train.backward", "train.optimizer")
    assert sum(host[n][0] for n in children) <= host["train.step"][0]
    assert trace.times(records) == {}  # no device ms on the CPU


def test_k_step_block_on_the_cpu_nests_its_steps():
    cfg, model = build()
    opt = train_lib.make_optimizer(cfg.train, 1 << 20, model.parameters())
    block = train_lib.make_detector_train_block(model, opt, cfg, 2)
    assert block.mode == "eager"
    b = [batch(cfg, seed) for seed in (1, 2)]
    stacked = {n: torch.stack([b[0][n], b[1][n]]) for n in b[0]}
    trace.enable()
    block(stacked, torch.Generator().manual_seed(5), 0.5)
    records = trace.collect()
    step = [(n, p or "train.block") for n, p in STEP]
    assert pairs(records) == [("train.block", None)] + step + step
    assert len({r["root"] for r in records}) == 1


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.card)])
def test_export_is_the_same_with_the_tracer_on(tmp_path, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, model = build(device)
    graphs = []
    for on in (False, True):
        trace.enable(on)
        path = str(tmp_path / f"m{on}.pt2")
        serving.export_detector(cfg, model, model.mean_sizes, 2, path)
        graphs.append(str(serving.load(path).graph))
    assert trace.collect() == []  # nothing recorded while exporting
    assert graphs[0] == graphs[1]
    assert "record_function" not in graphs[1]


def test_collect_clears_and_write_round_trips(tmp_path):
    trace.enable()
    with trace.span("outer"):
        with trace.span("inner"):
            pass
        partial = trace.collect()  # the open span stays for later
    records = partial + trace.collect()
    assert pairs(records) == [("inner", "outer"), ("outer", None)]
    assert trace.collect() == []
    path = tmp_path / "spans.jsonl"
    trace.write(path, records)
    assert [json.loads(line) for line in path.read_text().splitlines()] \
        == records


def test_profile_dir_writes_spans_beside_the_trace(tmp_path):
    profile = tmp_path / "profile"
    entry.main([*TINY, "data.device_synth=true", "train.batch_size=8",
                "data.num_points=512", "train.num_epochs=2",
                "train.eval_every=5", "train.log_every=4",
                f"train.ckpt_dir={tmp_path}",
                f"train.profile_dir={profile}"], device="cpu")
    assert (profile / "trace.json").exists()
    records = [json.loads(line)
               for line in (profile / "spans.jsonl").read_text().splitlines()]
    # the first epoch's 8 steps (64 // 8), each a root with its table
    assert pairs(records) == STEP * 8
    assert len({r["root"] for r in records}) == 8
    names = {e.get("name") for e in json.loads(
        (profile / "trace.json").read_text())["traceEvents"]}
    assert {"train.step", "detector.backbone"} <= names
    assert trace.span("a") is trace.span("b")  # off again: the no-op


def test_a_capture_samples_each_replay_once_done(fake_card):
    with trace.span("train.capture"):
        with trace.captured() as cap:
            with trace.span("train.step"):
                with trace.span("train.forward"):
                    pass
    captured = trace.collect()
    assert [(r["name"], r["phase"], r["device_ms"]) for r in captured] == [
        ("train.capture", "eager", 5.0), ("train.step", "capture", None),
        ("train.forward", "capture", None)]
    cap.sample()  # no replay yet: nothing
    assert trace.collect() == []

    def replay():
        for s in cap.spans:  # a replay records the captured events again
            s.begin.record()
        for s in reversed(cap.spans):
            s.end.record()
        cap.replayed()

    replay()
    cap.spans[0].end.t = None  # not finished: nothing, nothing waits
    cap.sample()
    assert trace.collect() == []
    replay()
    cap.sample()
    cap.sample()  # one sample a replay
    first = trace.collect()
    replay()
    second = trace.collect()  # collect() samples too
    for got in (first, second):
        assert [(r["name"], r["parent"], r["phase"], r["device_ms"])
                for r in got] == [("train.step", None, "replay", 3.0),
                                  ("train.forward", "train.step", "replay",
                                   1.0)]
    assert first[0]["root"] != second[0]["root"]
    assert len({r["root"] for r in first}) == 1
    trace.enable(False)
    replay()
    assert trace.collect() == []  # the tracer off: no sample


def _range(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _launch(ts, name="cudaLaunchKernel", cat="cuda_runtime"):
    return {"cat": cat, "name": name, "ts": ts, "dur": 1}


def test_trace_cells_counts_launches_by_the_innermost_range():
    events = [
        _range("serve.program", 0, 100), _range("detector.backbone", 10, 30),
        _range("backbone.sa1", 10, 5),  # starts with its parent
        _range("parse.nms", 50, 40), _range("detections", 100, 50),
        _range("serve.program", 200, 100), _range("parse.nms", 250, 10),
        _launch(5), _launch(10), _launch(20), _launch(55, "cuLaunchKernel",
                                                      "cuda_driver"),
        _launch(60), _launch(65, "cudaMemcpyAsync"), _launch(70),
        _launch(95), _launch(120), _launch(255), _launch(300),
        {"cat": "kernel", "name": "k", "ts": 61, "dur": 3}]
    counts, calls = trace_cells.launches_by_range(events)
    assert counts == {"serve.program": 2, "backbone.sa1": 1,
                      "detector.backbone": 1, "parse.nms": 4,
                      "(no program range)": 2}
    assert calls == {"serve.program": 2, "parse.nms": 2,
                     "detector.backbone": 1, "backbone.sa1": 1}


def _record(name, root, phase, device_ms=None, host_ms=None, parent=None):
    return {"name": name, "parent": parent, "root": root, "phase": phase,
            "start_ns": None if host_ms is None else 0,
            "end_ns": None if host_ms is None else int(host_ms * 1e6),
            "device_ms": device_ms}


def test_trace_cells_summary_reads_the_window():
    window = trace_cells.Window()
    parts = dict(zip(trace_cells.STEP_PARTS, (1.0, 20.0, 1.0, 40.0, 0.5)))
    window.records = [  # a capture's records, then two replayed steps
        _record("train.step", 0, "capture", host_ms=900.0),
        _record("train.forward", 0, "capture", host_ms=300.0)]
    for root, step_ms in ((1, 64.0), (2, 62.5)):
        window.records.append(_record("train.step", root, "replay", step_ms))
        window.records += [_record(n, root, "replay", ms, parent="train.step")
                           for n, ms in parts.items()]
    window.records.append(_record("serve.prepare", 3, "eager", host_ms=2.5))
    window.launches = {"parse.nms": 2142, "serve.program": 10}
    window.range_calls = {"parse.nms": 2, "serve.program": 2}
    got = trace_cells.Window.summary(window)
    assert got["readings"] == {
        "forward_ms": 20.0, "backward_ms": 40.0, "optimizer_ms": 0.5,
        "prepare_ms": 2.5, "nms_launches_per_request": 1071.0}
    assert got["replays"] == 2 and got["records"]["train.step"] == 2
    assert got["step_cover"] == [62.5 / 64.0, 1.0]
    assert got["host_ms"] == {"serve.prepare": 2.5}  # no capture's


def test_trace_cells_collects_the_measured_window_alone():
    window = trace_cells.Window()
    units = iter((3, 7))

    def loop(seconds):
        with trace.span("serve.prepare"):
            pass
        return {"units": next(units)}

    def measure(ctx, loop, spans=None):  # the window, then a traced one
        return loop(ctx.seconds), loop(1.0)

    trace.enable()
    with trace.span("setup"):
        pass
    measured, traced = window.wrap_measure(measure)(
        types.SimpleNamespace(seconds=2.0), loop)
    assert (measured, traced) == ({"units": 3}, {"units": 7})
    assert pairs(window.records) == [("serve.prepare", None)]
    assert window.units == 3 and set(window.gc) == {0, 1, 2}
    assert pairs(trace.collect()) == [("serve.prepare", None)]  # the 2nd


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.card
def test_captured_step_gives_per_replay_stage_times(card, monkeypatch):
    cfg, model = build(card)
    opt = train_lib.make_optimizer(cfg.train, 1 << 20, model.parameters())
    block = train_lib.make_detector_train_block(model, opt, cfg, 2)
    b = [batch(cfg, seed, card) for seed in (1, 2)]
    stacked = {n: torch.stack([b[0][n], b[1][n]]) for n in b[0]}
    gen = torch.Generator(device=card).manual_seed(5)
    trace.enable()
    for _ in range(2):  # the eager warm-up, then the capture and replays
        block(stacked, gen, 0.5)["loss"].tolist()
    assert block.mode == "graph" and len(block.spans.spans) == len(STEP)
    trace.collect()

    waits = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: waits.append(a))
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda *a: waits.append(a))
    for _ in range(3):
        block(stacked, gen, 0.5)["loss"].tolist()  # the host reads the loss
    assert waits == []  # the tracer added no synchronisation
    monkeypatch.undo()
    torch.cuda.synchronize()
    records = trace.collect()
    replays = [r for r in records if r["phase"] == "replay"]
    # a sample at the start of calls 2 and 3, and one more in collect()
    assert len(replays) == 3 * len(STEP)
    assert pairs(replays) == STEP * 3
    ms = trace.times(replays)
    for n, _ in STEP:
        assert all(t > 0 for t in ms[n]), n
    children = ("train.augment", "train.forward", "train.loss",
                "train.backward", "train.optimizer")
    for i in range(3):
        inside = sum(ms[n][i] for n in children)
        assert 0.9 * ms["train.step"][i] <= inside <= ms["train.step"][i]


@pytest.mark.card
def test_served_call_on_the_card_times_each_layer(card):
    cfg, model = build(card)
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes)
    trace.enable()
    infer(*scenes(card))
    torch.cuda.synchronize()
    records = trace.collect()
    assert pairs(records) == SERVED
    ms = trace.times(records)
    assert all(ms[n][0] > 0 for n, _ in SERVED)
    assert ms["detector.backbone"][0] <= ms["serve.program"][0]
