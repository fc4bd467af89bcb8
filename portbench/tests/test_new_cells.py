"""The KITTI cell (driver outdoor) as a toy cell on the CPU: it runs
through the harness from a copy of the benchmark with only new files and
entries added, correct, and its traced run reports its per-layer
metrics; an answer altered in the served program makes it not correct.
BENCHMARK.json's new entries name files that exist."""

import json
import shutil

import pytest

from conftest import BENCH, REPO, TOY_MODEL, run_cell

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
TOYS = (
    ("toy-kitti-b2", "toy-kitti", "sadet-kitti-16k", "eval-kitti-b8",
     dict(batch=2, raw_points=32768, budget=512, pool_batches=2, warmup=1,
          check_batches=2, trace_seconds=1)),
)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell, config, base, real, traffic in TOYS:
        cfg = json.loads((BENCH / "configs" / f"{base}.json").read_text())
        cfg["name"] = config
        cfg["model"].update(TOY_MODEL, num_classes=cfg["model"]
                            ["num_classes"])
        (root / "portbench" / "configs" / f"{config}.json").write_text(
            json.dumps(cfg))
        bench["configs"].append({"name": config, "source": "a toy",
                                 "file": f"portbench/configs/{config}.json",
                                 "reduced": [], "why": "a toy"})
        template = json.loads((BENCH / "workloads"
                               / f"{real}.json").read_text())
        (root / "portbench" / "workloads" / f"{cell}.json").write_text(
            json.dumps(dict(template, **traffic)))
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": cell, "chips": 1,
                                   "why": "a toy"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.mark.parametrize("cell", [t[0] for t in TOYS])
def test_toy_cell_runs_correct(root, cell):
    line, err = run_cell(root, cell, seed=2200000101)
    assert line["correct"] is True, err[-3000:]
    assert "setup_s" in line["metrics"] and line["attempted"] > 0


@pytest.mark.parametrize("cell,metric", [("toy-kitti-b2", "kitti.mfu")])
def test_traced_toy_cell_reports_its_metrics(root, cell, metric):
    line, _ = run_cell(root, cell, seed=2**31 + 23, trace=1)
    assert line["correct"] is True and metric in line["metrics"]
    assert "setup_s" not in line["metrics"]


def test_altered_answer_fails_the_kitti_cell(root):
    line, _ = run_cell(root, "toy-kitti-b2", seed=2200000102,
                       fault="answer")
    assert line["correct"] is False
    assert line["checks"]["mismatch_share"]["value"] > 1.0
    assert line["checks"]["pick_mismatch_share"]["value"] == 0.0


def test_new_entries():
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert cells["eval-kitti-b8"]["chips"] == 1
    for m in SPEC["per_layer"]:
        if m["name"].startswith("kitti."):
            assert (BENCH / "metrics" / f"{m['name']}.py").exists()
            assert m["workloads"] == ["eval-kitti-b8"]
