"""A cell, a configuration and a metric are added as new files and new
BENCHMARK.json entries alone: the toy cells of conftest run from a copy
in which no file of the benchmark was edited, and their last lines carry
the keys the result line must have."""

import hashlib

import pytest

from conftest import BENCH, TOY_CELLS, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_no_file_of_the_benchmark_is_edited(toy_root):
    for path in BENCH.rglob("*"):
        if path.is_file() and "tests" not in path.parts \
                and "__pycache__" not in path.parts:
            copy = toy_root / "portbench" / path.relative_to(BENCH)
            assert digest(copy) == digest(path), path


@pytest.mark.parametrize("cell", [c[0] for c in TOY_CELLS])
def test_toy_cell_runs_correct(toy_root, cell):
    line, err = run_cell(toy_root, cell)
    assert line["correct"] is True, err[-3000:]
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert "setup_s" in line["metrics"]
    assert line["attempted"] > 0 and line["failed"] == 0
    # the numbers compared close standard error, beside their limits
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for name, c in line["checks"].items():
        assert any(t.startswith(f"check {name}: ") and "limit" in t
                   for t in tail)
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", ["toy-sweep", "toy-train-k2"])
def test_traced_run_reports_per_layer_metrics(toy_root, cell):
    line, _ = run_cell(toy_root, cell, seed=2**31 + 11, trace=1)
    assert line["correct"] is True
    assert "setup_s" not in line["metrics"]
    assert any(n.endswith(".mfu") for n in line["metrics"])
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
