"""Tests of the benchmark itself. Most run on the CPU at toy sizes; those
marked `card` need a CUDA device and skip without one (decided inside the
`card` fixture, never while a module is imported).

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

TOY_MODEL = dict(num_classes=4, sa_npoints=[64, 32, 16, 8],
                 sa_radii=[0.6, 1.0, 1.6, 2.4], sa_nsamples=[8, 8, 4, 4],
                 sa_channels=[[8, 8, 16], [16, 16, 32], [16, 16, 32],
                              [16, 16, 32]],
                 fp_channels=[[32, 32], [32, 32]], seed_feat_dim=32,
                 num_proposals=8, cluster_nsample=4)
# toy cells: (cell, configuration, the real cell whose workload file it
# starts from and whose metrics it reports, traffic)
TOY_CELLS = (
    ("toy-sweep", "toy-serve", "sweep-sunrgbd20k-b32",
     dict(batch=2, points=240, budget=256, pool_batches=2, warmup=1,
          check_batches=1, trace_seconds=1)),
    ("toy-latency", "toy-serve", "latency-sunrgbd20k-b1",
     dict(raw_points=600, budget=256, pool_scenes=4, calibrate=2, warmup=1,
          check_scenes=2, rate_hz=50, trace_seconds=1)),
    ("toy-train-k2", "toy-train", "train-scannet40k-b8-k8",
     dict(steps_per_call=2, batch=2, points=240, budget=256, pool_steps=4,
          warmup_calls=2, sync_steps=2, trace_seconds=1)),
    ("toy-train-k1", "toy-train", "train-scannet40k-b8-k1",
     dict(steps_per_call=1, batch=2, points=240, budget=256, pool_steps=4,
          warmup_calls=3, sync_steps=2, trace_seconds=1)),
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def toy_config(name: str, base: str, tf32: bool) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{base}.json").read_text())
    cfg["name"] = name
    cfg["model"].update(TOY_MODEL)
    cfg["data"]["num_points"] = 256
    cfg["train"]["bf16_matmul"] = tf32
    return cfg


def add_toy_cells(root: Path) -> None:
    """Add the toy configurations and cells to the benchmark copied under
    `root`: new files, and new entries in its BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, base, tf32 in (("toy-serve", "sadet-sunrgbd-20k", False),
                             ("toy-train", "sadet-scannet-40k", True)):
        path = root / "portbench" / "configs" / f"{name}.json"
        path.write_text(json.dumps(toy_config(name, base, tf32)))
        bench["configs"].append({"name": name, "source": "a toy",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "a toy"})
    for cell, config, real, traffic in TOY_CELLS:
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


@pytest.fixture(scope="session")
def toy_root(tmp_path_factory) -> Path:
    """A copy of BENCHMARK.json and portbench/ with the toy cells added."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_toy_cells(root)
    return root


LAUNCH = BENCH / "tests" / "launch.py"


def run_cell(root: Path, cell: str, seed: int = 12345678901, trace: int = 0,
             fault: str = "", device: str = "cpu") -> tuple[dict, str]:
    """Run a cell of the benchmark under `root` on `device` (the harness's
    look for a card skipped) in a fresh process, with `fault` planted in
    the program; returns (the last line of standard output, standard
    error)."""
    proc = subprocess.run(
        [sys.executable, str(LAUNCH), str(root), str(REPO), fault, device,
         "--workload", cell, "--seed", str(seed), "--seconds", "1",
         "--trace", str(trace)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr
