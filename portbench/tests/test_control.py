"""The controls fail the comparison: the reference one precision below the
configuration's (TF32 for fp32, bf16 for TF32 products) and the training
faults, read on the card at a size a test run holds. The full-size
readings come from `python3 portbench/control.py` on the card."""

import json

import pytest

from conftest import BENCH
from portbench import control

pytestmark = pytest.mark.card


def load(cell):
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    c = {w["name"]: w for w in bench["workloads"]}[cell]
    conf = {x["name"]: x for x in bench["configs"]}[c["config"]]
    return (json.loads((BENCH.parent / conf["file"]).read_text()),
            json.loads((BENCH / "workloads" / f"{cell}.json").read_text()))


def test_serving_control_fails(card):
    config, workload = load("sweep-sunrgbd20k-b32")
    small = dict(workload, batch=4, pool_batches=2, check_batches=1)
    got = control.serve_control(config, small, 7, card, 20)
    assert got["mismatch_share"] > workload["limits"]["mismatch_share"]


def test_training_control_and_faults_fail(card):
    config, workload = load("train-scannet40k-b8-k8")
    small = dict(workload, batch=2, pool_steps=3)
    got = control.train_control(config, small, 7, card)
    for case in ("control", "half_batch", "state_unchanged"):
        assert any(got[case][n] > workload["limits"][n]
                   for n in workload["limits"]), case
