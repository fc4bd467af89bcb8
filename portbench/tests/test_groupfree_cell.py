"""The Group-Free cell (driver groupfree) as a toy cell on the CPU: it runs
through the harness from a copy of the benchmark with only new files and
entries added, correct, and its traced run reports its metrics; an answer
altered in the served program makes it not correct. BENCHMARK.json names
the cell's files and its metrics' readers, and the counted calls and
FLOPs are the program's."""

import json
import re
import shutil

import pytest

from conftest import BENCH, REPO, run_cell

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELL, REAL = "toy-groupfree-b2", "eval-groupfree-scannet-b16"
CONFIG = "groupfree3d-scannet-l12o256"
# every count and width scaled down: 3 decoder layers of 32 channels in 4
# heads over 64 seeds, 16 candidates
TOY = dict(sa_npoints=[256, 64, 32, 16], sa_radii=[0.4, 0.8, 1.2, 1.6],
           sa_nsamples=[16, 8, 8, 8],
           sa_channels=[[16, 16, 32], [32, 32, 32], [32, 32, 32],
                        [32, 32, 32]],
           fp_channels=[[32, 32], [32, 32]], groupfree_candidates=16,
           groupfree_layers=3,
           groupfree_heads=4, groupfree_ffn=64,
           groupfree_head_channels=[32, 32])
TRAFFIC = dict(batch=2, points=1000, budget=1024, pool_batches=2,
               warmup=1, check_batches=2, trace_seconds=1)
METRICS = ["groupfree.decoder_ms", "groupfree.attention_ms",
           "groupfree.parse_ms", "groupfree.box_points_roofline",
           "groupfree.mfu", "groupfree.device_idle_share",
           "groupfree.fps_roofline", "groupfree.ball_query_roofline"]


def toy_config() -> dict:
    cfg = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    cfg["name"] = "toy-groupfree"
    cfg["model"].update(TOY)
    cfg["data"]["num_points"] = TRAFFIC["budget"]
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "portbench" / "configs" / "toy-groupfree.json").write_text(
        json.dumps(toy_config()))
    bench["configs"].append({"name": "toy-groupfree", "source": "a toy",
                             "file": "portbench/configs/toy-groupfree.json",
                             "reduced": [], "why": "a toy"})
    template = json.loads((BENCH / "workloads" / f"{REAL}.json").read_text())
    (root / "portbench" / "workloads" / f"{CELL}.json").write_text(
        json.dumps(dict(template, **TRAFFIC)))
    bench["workloads"].append({"name": CELL, "config": "toy-groupfree",
                               "traffic": CELL, "chips": 1, "why": "a toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def test_toy_cell_runs_correct(root):
    line, err = run_cell(root, CELL, seed=2400000101)
    assert line["correct"] is True, err[-3000:]
    checks = line["checks"]
    assert checks["kps_mismatch_share"]["value"] == 0.0
    assert checks["box_count_mismatch_share"]["value"] == 0.0
    assert "setup_s" in line["metrics"] and line["attempted"] > 0
    assert "serve_scenes_per_s" in line["metrics"]
    # the picks and counts held are the timed requests' own
    assert re.search(r"groupfree: .* over [1-9][0-9]* checked requests",
                     err), err[-3000:]


def test_traced_toy_cell_reports_its_metrics(root):
    """On the CPU the spans have no device ms and the trace no kernel, so
    of the eight the share of the peak and the idle share are read."""
    line, _ = run_cell(root, CELL, seed=2**31 + 26, trace=1)
    assert line["correct"] is True
    assert "groupfree.mfu" in line["metrics"]
    assert "groupfree.device_idle_share" in line["metrics"]
    assert "setup_s" not in line["metrics"]
    assert set(line["metrics"]) <= set(METRICS)


def test_altered_answer_fails_the_cell(root):
    line, _ = run_cell(root, CELL, seed=2400000102, fault="answer")
    assert line["correct"] is False
    assert line["checks"]["mismatch_share"]["value"] > 1.0
    assert line["checks"]["kps_mismatch_share"]["value"] == 0.0


def test_entries():
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert cells[REAL]["chips"] == 1
    assert cells[REAL]["config"] == CONFIG
    assert len(cells[REAL]["why"]) <= 200
    serve = {m["name"]: m for m in SPEC["end_to_end"]}["serve_scenes_per_s"]
    assert REAL in serve["workloads"]
    names = [m["name"] for m in SPEC["per_layer"]
             if m["name"].startswith("groupfree.")]
    assert names == METRICS
    for m in SPEC["per_layer"]:
        if m["name"] in names:
            assert (BENCH / "metrics" / f"{m['name']}.py").exists()
            assert m["workloads"] == [REAL]
    config = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    model = config["model"]
    assert config["reduced"] == []
    assert (model["groupfree_layers"], model["groupfree_candidates"],
            model["fp_channels"][1][-1], model["groupfree_heads"],
            model["groupfree_ffn"]) == (12, 256, 288, 8, 2048)


def test_counted_calls_and_flops_at_the_cells_shapes():
    """The B1 and ball-query calls of one request of the cell, by hand (the
    four set abstractions: KPS takes no FPS), the point count of 768 boxes
    a scene, and the FLOPs of a scene: about 22.7 G in the decoder's 12
    layers (0.73 cross-attention, 0.60 FFN, 0.25 self-attention, 0.21
    position embeddings, 0.10 box head a layer) and 10.9 G elsewhere."""
    from portbench.counts import groupfree as counts

    model = json.loads((BENCH / "configs" / f"{CONFIG}.json")
                       .read_text())["model"]
    assert [(c["n"], c["m"]) for c in counts.fps_calls(model, 16, 51200)] \
        == [(51200, 2048), (2048, 1024), (1024, 512), (512, 256)]
    assert [(c["n"], c["m"], c["k"]) for c in counts.ball_query_calls(
        model, 16, 51200)] == [(51200, 2048, 64), (2048, 1024, 32),
                               (1024, 512, 16), (512, 256, 16)]
    assert counts.box_points_calls(model, 16, 51200) == [
        {"B": 16, "n": 51200, "p": 768}]
    ops, nbytes = counts.box_points_cost({"B": 16, "n": 51200, "p": 768})
    assert ops == 16 * 768 * 51200 * 9
    assert nbytes == 16 * 51200 * 13 + 16 * 768 * 28
    one = dict(model, groupfree_layers=1)
    none = dict(model, groupfree_layers=0)
    layer = counts.forward_flops(one) - counts.forward_flops(none)
    assert layer == pytest.approx(1.89e9, rel=0.01)
    assert counts.forward_flops(none) == pytest.approx(10.9e9, rel=0.01)
    assert counts.forward_flops(model) == pytest.approx(33.57e9, rel=0.001)


def test_counted_calls_and_flops_are_the_programs():
    """counts/groupfree.py's FPS, ball-query and point-count calls are the
    ops one request of the program calls, shape for shape, and its
    products are the program's Linear layers and attention products, at
    the toy cell's sizes (a CPU trace of the request's aten ops)."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.counts import groupfree as counts
    from portbench.harness import Context
    from tpu3dsad_torch import serving, train_lib
    from tpu3dsad_torch.ops import library
    from tpu3dsad_torch.train_detector import build_detector

    config = toy_config()
    N, B = TRAFFIC["budget"], TRAFFIC["batch"]
    cfg = Context.port_config(type("Ctx", (), {"config": config})())
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg, device="cpu")
    seen = {"fps": [], "ball_query": [], "box_points": []}
    saved = {name: getattr(library, name) for name in seen}

    def recorder(name):
        def call(points, *args, **kwargs):
            b, n = points.shape[:2]
            if name == "ball_query":
                centers, _, k = args[:3]
                seen[name].append({"B": b, "n": n, "m": centers.shape[1],
                                   "k": k})
            elif name == "box_points":
                seen[name].append({"B": b, "n": n, "p": args[0].shape[1]})
            else:
                seen[name].append({"B": b, "n": n, "m": args[0]})
            return saved[name](points, *args, **kwargs)
        return call

    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-2, 2, (B, N, 3)).astype(np.float32))
    mask = torch.ones(B, N, dtype=torch.bool)
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes)
    for name in seen:
        setattr(library, name, recorder(name))
    try:
        with FlopCounterMode(display=False) as flops:
            infer(pts, mask)
    finally:
        for name, fn in saved.items():
            setattr(library, name, fn)
    model_cfg = config["model"]
    assert seen["fps"] == counts.fps_calls(model_cfg, B, N)
    assert seen["ball_query"] == counts.ball_query_calls(model_cfg, B, N)
    assert seen["box_points"] == counts.box_points_calls(model_cfg, B, N)
    # the matmuls of the request but FP's 3-NN interpolations, a weighted
    # sum of 3 rows (einsum, as bmm), which are not counted; the 3-NN
    # distances are a custom op the counter does not see
    per_op = flops.get_flop_counts()["Global"]
    matmul = sum(v for k, v in per_op.items()
                 if str(k).split(".")[-1] in ("mm", "addmm", "bmm"))
    n, c = model_cfg["sa_npoints"], model_cfg["sa_channels"]
    interp = 2 * B * 3 * (n[2] * c[3][-1]
                          + n[1] * model_cfg["fp_channels"][0][-1])
    assert matmul - interp == B * counts.forward_flops(model_cfg)


def reader(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def trace_of(kernels, spans=None, units=60):
    from portbench.harness import Trace

    model = json.loads((BENCH / "configs" / f"{CONFIG}.json")
                       .read_text())["model"]
    return Trace(window_s=4.0, busy_s=3.9, kernels=kernels, device_ops=[],
                 idle_gaps=[], units=units, scenes=16 * units,
                 scenes_per_s=400.0, spans=spans or {}, model=model,
                 batch=16, points=51200, precision="fp32")


TESTS = 16 * 768 * 51200


@pytest.mark.parametrize("launches, read", [(60, True), (120, False),
                                            (59, False)],
                         ids=["one-a-request", "two-a-request", "one-short"])
def test_box_points_roofline_reads_the_kernel(launches, read):
    """groupfree.box_points_roofline: the count's bound (its operations,
    84.5 us a request) over the kernel's device time; nothing where the
    launches are not one a request."""
    kernels = {"void box_points_kernel(float const*)": (0.012, launches)}
    got = reader("groupfree.box_points_roofline")(trace_of(kernels))
    if not read:
        assert got is None
        return
    assert got == pytest.approx(100 * TESTS * 9 / 67e12 * 60 / 0.012)


@pytest.mark.parametrize("spans, want", [
    ({"decoder.self_attn": [1.0, 2.0], "decoder.cross_attn": [3.0, 4.0]},
     5.0),
    ({"decoder.self_attn": [1.0]}, None),
], ids=["both", "one-missing"])
def test_attention_ms_sums_the_two_attentions(spans, want):
    got = reader("groupfree.attention_ms")(trace_of({}, spans))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("spans, want", [
    ({"parse.decode": [0.1], "parse.box_points": [0.2],
      "parse.nms": [0.3]}, 0.6),
    ({"parse.decode": [0.1], "parse.nms": [0.3]}, None),
], ids=["all-three", "no-count"])
def test_parse_ms_sums_decode_count_and_nms(spans, want):
    got = reader("groupfree.parse_ms")(trace_of({}, spans))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("per_request, read", [(4, True), (5, False)],
                         ids=["four-a-request", "launches-differ"])
def test_fps_roofline_reads_the_four_levels(per_request, read):
    kernels = {"void fps_cluster_kernel<16>(float const*)":
               (0.3, 60 * per_request)}
    got = reader("groupfree.fps_roofline")(trace_of(kernels))
    assert (got is not None) == read


def test_each_control_fails_a_check_at_the_toy_size():
    """control_groupfree.py at the toy cell's sizes on the CPU: every fault
    but tf32 (the CPU's products have no TF32) reads above the cell's
    limit in mismatch_share; the KPS picks, made before the decoder and
    the parse, are the sound ones under every fault."""
    import torch

    from portbench import control_groupfree as control

    faults = {k: v for k, v in control.FAULTS.items() if k != "tf32"}
    w = json.loads((BENCH / "workloads" / f"{REAL}.json").read_text())
    got = control.controls(toy_config(), dict(w, **TRAFFIC), 2400000103,
                           torch.device("cpu"), faults)
    limits = w["limits"]
    for name in faults:
        assert got["mismatch_share"][name] > limits["mismatch_share"], name
        assert got["kps_mismatch_share"][name] == 0.0, name
    assert got["mismatch_share"]["last_stage"] == 100.0
    assert got["nonempty_boxes"] > 0 and got["kept_boxes"] > 0
