"""The 3DSSD cell (driver ssd3d) as a toy cell on the CPU: it runs through
the harness from a copy of the benchmark with only new files and entries
added, correct, and its traced run reports its share of the peak; an
answer altered in the served program makes it not correct. BENCHMARK.json
names the cell's files and its metrics' readers."""

import json
import shutil

import pytest

from conftest import BENCH, REPO, run_cell

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELL, REAL = "toy-3dssd-b2", "eval-3dssd-kitti-b16"
# the sampling counts scaled down, every width as published
TOY = dict(ssd3d_npoints=[[512], [64], [32, 32]],
           ssd3d_fps_ranges=[[-1], [-1], [64, -1]])
TRAFFIC = dict(batch=2, raw_points=32768, budget=2048, pool_batches=2,
               warmup=1, check_batches=2, trace_seconds=1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "3dssd-kitti-car-16k.json")
                     .read_text())
    cfg["name"] = "toy-3dssd"
    cfg["model"].update(TOY)
    cfg["data"]["num_points"] = TRAFFIC["budget"]
    (root / "portbench" / "configs" / "toy-3dssd.json").write_text(
        json.dumps(cfg))
    bench["configs"].append({"name": "toy-3dssd", "source": "a toy",
                             "file": "portbench/configs/toy-3dssd.json",
                             "reduced": [], "why": "a toy"})
    template = json.loads((BENCH / "workloads" / f"{REAL}.json").read_text())
    (root / "portbench" / "workloads" / f"{CELL}.json").write_text(
        json.dumps(dict(template, **TRAFFIC)))
    bench["workloads"].append({"name": CELL, "config": "toy-3dssd",
                               "traffic": CELL, "chips": 1, "why": "a toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def test_toy_cell_runs_correct(root):
    line, err = run_cell(root, CELL, seed=2400000101)
    assert line["correct"] is True, err[-3000:]
    assert line["checks"]["pick_mismatch_share"]["value"] == 0.0
    assert "setup_s" in line["metrics"] and line["attempted"] > 0
    assert "serve_scenes_per_s" in line["metrics"]


def test_traced_toy_cell_reports_its_share_of_the_peak(root):
    line, _ = run_cell(root, CELL, seed=2**31 + 24, trace=1)
    assert line["correct"] is True and "ssd3d.mfu" in line["metrics"]
    assert "setup_s" not in line["metrics"]


def test_altered_answer_fails_the_cell(root):
    line, _ = run_cell(root, CELL, seed=2400000102, fault="answer")
    assert line["correct"] is False
    assert line["checks"]["mismatch_share"]["value"] > 1.0
    assert line["checks"]["pick_mismatch_share"]["value"] == 0.0


def test_entries():
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert cells[REAL]["chips"] == 1
    assert cells[REAL]["config"] == "3dssd-kitti-car-16k"
    serve = {m["name"]: m for m in SPEC["end_to_end"]}["serve_scenes_per_s"]
    assert REAL in serve["workloads"]
    names = [m["name"] for m in SPEC["per_layer"]
             if m["name"].startswith("ssd3d.")]
    assert names == ["ssd3d.ffps_roofline", "ssd3d.sampling_ms",
                     "ssd3d.cg_ms", "ssd3d.mfu", "ssd3d.device_idle_share",
                     "ssd3d.fps_roofline", "ssd3d.ball_query_roofline",
                     "ssd3d.nms_ms"]
    for m in SPEC["per_layer"]:
        if m["name"] in names:
            assert (BENCH / "metrics" / f"{m['name']}.py").exists()
            assert m["workloads"] == [REAL]


def test_counted_calls_at_the_cells_shapes():
    """The D-FPS and ball-query calls of one request of the cell, by hand:
    SA1's D-FPS over the scan, SA2's FS half over SA1's 4096 points, SA3's
    over points [512, 1024); 3 ball queries a level around its centres,
    then 2 over SA3's 512 points around the 256 votes."""
    from portbench.counts import ssd3d as counts

    model = json.loads((BENCH / "configs" / "3dssd-kitti-car-16k.json")
                       .read_text())["model"]
    assert [(c["n"], c["m"]) for c in counts.dfps_calls(model, 16, 16384)] \
        == [(16384, 4096), (4096, 512), (512, 256)]
    assert [(c["n"], c["m"], c["k"]) for c in counts.ball_query_calls(
        model, 16, 16384)] == [
        (16384, 4096, 32), (16384, 4096, 32), (16384, 4096, 64),
        (4096, 1024, 32), (4096, 1024, 32), (4096, 1024, 64),
        (1024, 512, 32), (1024, 512, 32), (1024, 512, 32),
        (512, 256, 16), (512, 256, 32)]
    assert {c["B"] for c in counts.ball_query_calls(model, 16, 16384)} == {16}


def test_counted_calls_are_the_programs():
    """counts/ssd3d.py's D-FPS, F-FPS and ball-query calls are the ops one
    request of the program calls, shape for shape, at the toy cell's
    sizes."""
    import numpy as np
    import torch

    from portbench.counts import ssd3d as counts
    from portbench.harness import Context
    from tpu3dsad_torch import serving, train_lib
    from tpu3dsad_torch.ops import library
    from tpu3dsad_torch.train_detector import build_detector

    config = json.loads((BENCH / "configs" / "3dssd-kitti-car-16k.json")
                        .read_text())
    config["model"].update(TOY)
    config["data"]["num_points"] = N = TRAFFIC["budget"]
    B = TRAFFIC["batch"]
    cfg = Context.port_config(type("Ctx", (), {"config": config})())
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg, device="cpu")
    seen = {"fps": [], "ffps": [], "ball_query": []}
    saved = {name: getattr(library, name) for name in seen}

    def recorder(name):
        def call(points, *args, **kwargs):
            b, n = points.shape[:2]
            if name == "ball_query":
                centers, _, k = args[:3]
                seen[name].append({"B": b, "n": n, "m": centers.shape[1],
                                   "k": k})
            elif name == "ffps":
                seen[name].append({"B": b, "n": n, "d": points.shape[2],
                                   "m": args[0]})
            else:
                seen[name].append({"B": b, "n": n, "m": args[0]})
            return saved[name](points, *args, **kwargs)
        return call

    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform([0, -20, -2], [40, 20, 1],
                                       (B, N, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.random((B, N, 1)).astype(np.float32))
    mask = torch.ones(B, N, dtype=torch.bool)
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes,
                                       with_features=True)
    for name in seen:
        setattr(library, name, recorder(name))
    try:
        infer(pts, mask, feats)
    finally:
        for name, fn in saved.items():
            setattr(library, name, fn)
    model_cfg = config["model"]
    assert seen["fps"] == counts.dfps_calls(model_cfg, B, N)
    assert seen["ffps"] == counts.ffps_calls(model_cfg, B, N)
    assert seen["ball_query"] == counts.ball_query_calls(model_cfg, B, N)


def reader(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def trace_of(kernels, spans=None, units=60):
    from portbench.harness import Trace

    model = json.loads((BENCH / "configs" / "3dssd-kitti-car-16k.json")
                       .read_text())["model"]
    return Trace(window_s=4.0, busy_s=3.9, kernels=kernels, device_ops=[],
                 idle_gaps=[], units=units, scenes=16 * units,
                 scenes_per_s=240.0, spans=spans or {}, model=model,
                 batch=16, points=16384, precision="fp32")


@pytest.mark.parametrize("per_request, read", [(3, True), (4, False)],
                         ids=["three-a-request", "launches-differ"])
def test_fps_roofline_reads_the_d_fps_launches(per_request, read):
    """ssd3d.fps_roofline: the 3 D-FPS calls' bound (0.1655 ms a request)
    over B1's device time, the F-FPS kernel's time not counted; nothing
    where the trace's B1 launches are not 3 a request."""
    from portbench.counts import bound_seconds, fps_cost
    from portbench.counts.ssd3d import dfps_calls

    kernels = {"void fps_cluster_kernel<16>(float const*)":
               (0.168, 60 * per_request),
               "void ffps_kernel<2>(float4 const*)": (0.09, 120)}
    got = reader("ssd3d.fps_roofline")(trace_of(kernels))
    if not read:
        assert got is None
        return
    bound = bound_seconds(fps_cost(c) for c in dfps_calls(
        trace_of({}).model, 16, 16384))
    assert got == pytest.approx(100 * bound * 60 / 0.168)
    assert 5.0 < got < 7.0


@pytest.mark.parametrize("per_request, read", [(11, True), (7, False)],
                         ids=["eleven-a-request", "launches-differ"])
def test_ball_query_roofline_reads_the_staging_and_scans(per_request, read):
    """ssd3d.ball_query_roofline: the 11 ball queries' bound over the
    staging's and the scans' device time; nothing where the scans are not
    11 a request."""
    kernels = {"void ball_query_kernel<4, true>(float const*)":
               (0.150, 60 * per_request),
               "void stage_kernel(float const*)": (0.010, 60 * per_request)}
    got = reader("ssd3d.ball_query_roofline")(trace_of(kernels))
    if not read:
        assert got is None
        return
    assert got == pytest.approx(100 * 0.01909347343283582e-3 * 60 / 0.160)


@pytest.mark.parametrize("spans, want", [
    ({"parse.nms": [0.25, 0.35]}, 0.3),
    ({"parse.decode": [0.1]}, None),
    ({"parse.nms": []}, None),
], ids=["span", "no-span", "empty"])
def test_nms_ms_reads_the_parse_nms_span(spans, want):
    got = reader("ssd3d.nms_ms")(trace_of({}, spans))
    assert got == (None if want is None else pytest.approx(want))
