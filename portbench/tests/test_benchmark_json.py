"""BENCHMARK.json names only what the benchmark has: each cell's workload
file, configuration file and driver, each per-layer metric's reader, and
keys and names within the limits of the format."""

import json
import re

import pytest

from conftest import BENCH

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files_exist(cell):
    workload = json.loads(
        (BENCH / "workloads" / f"{cell['name']}.json").read_text())
    assert (BENCH / "drivers" / f"{workload['driver']}.py").exists()
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    reported = [m for m in SPEC["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert any(cell["name"] in m["workloads"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_one_run(config):
    data = json.loads((BENCH.parent / config["file"]).read_text())
    assert data["name"] == config["name"] and data["reduced"] == \
        config["reduced"]


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{metric['name']}.py").exists()
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    else:
        assert 0.01 <= metric["bound"] <= 0.25
