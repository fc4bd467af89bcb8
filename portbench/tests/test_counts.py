"""The roofline and FLOP counts, pinned to values worked by hand."""

import json

import pytest

from conftest import BENCH
from portbench import counts


def model(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())["model"]


def test_fps_cost_one_call():
    # 4 points to 3 picks: 4 * 2 * 10 ops; 4 * 12 + 4 bytes in, 3 * 4 out
    assert counts.fps_cost({"B": 1, "n": 4, "m": 3}) == (80.0, 64.0)


def test_ball_query_cost_one_call():
    # per cloud: 10 * 12 + 10 + 4 * 12 read, 4 * 8 * 4 + 4 * 4 written
    assert counts.ball_query_cost({"B": 2, "n": 10, "m": 4, "k": 8}) == (
        0.0, 2 * (120 + 10 + 48 + 128 + 16))


def test_scatter_cost_one_call():
    # g 6 x 5 floats, idx 6 ints, out 3 x 5 floats
    assert counts.scatter_cost({"B": 1, "u": 6, "c": 5, "n": 3}) == (
        0.0, 120 + 24 + 60)


def test_bound_takes_the_larger_roofline():
    ops, nbytes = 67e12, 3.35e12 / 2  # 1 s of fp32 work, 0.5 s of bytes
    assert counts.bound_seconds([(ops, nbytes)]) == pytest.approx(1.0)
    assert counts.bound_seconds([(0.0, 3.35e12)]) == pytest.approx(1.0)


# (rows, in, out) of one scene of the SUN RGB-D configuration, by hand
SUNRGBD_LAYERS = [
    (2048 * 64, 4, 64), (2048 * 64, 64, 64), (2048 * 64, 64, 128),
    (1024 * 32, 131, 128), (1024 * 32, 128, 128), (1024 * 32, 128, 256),
    (512 * 16, 259, 128), (512 * 16, 128, 128), (512 * 16, 128, 256),
    (256 * 16, 259, 128), (256 * 16, 128, 128), (256 * 16, 128, 256),
    (512, 512, 256), (512, 256, 256),
    (1024, 512, 256), (1024, 256, 256),
    (1024, 256, 256), (1024, 256, 256), (1024, 256, 259),
    *[(256 * 16, 259, 128), (256 * 16, 128, 128), (256 * 16, 128, 128)] * 3,
    (256, 384, 128), (256, 128, 3),
    (256, 128, 128), (256, 128, 128), (256, 128, 79),
]


def test_layers_of_one_scene():
    assert counts.layers(model("sadet-sunrgbd-20k")) == SUNRGBD_LAYERS


@pytest.mark.parametrize("name,flops", [
    ("sadet-sunrgbd-20k", 12_306_743_296),
    # 18 classes and 1 heading bin: the head's output 2 + 3 + 2 + 5 x 18 =
    # 97 wide, not 2 + 3 + 2 x 12 + 5 x 10 = 79
    ("sadet-scannet-40k", 12_306_743_296 + 2 * 256 * 128 * 18),
])
def test_forward_flops_of_one_scene(name, flops):
    assert counts.forward_flops(model(name)) == flops


def test_calls_of_one_request_and_one_step():
    m = model("sadet-scannet-40k")
    assert counts.fps_calls(m, 8, 40960) == [
        {"B": 8, "n": 40960, "m": 2048}, {"B": 8, "n": 2048, "m": 1024},
        {"B": 8, "n": 1024, "m": 512}, {"B": 8, "n": 512, "m": 256},
        {"B": 8, "n": 1024, "m": 256}]
    assert [c["k"] for c in counts.ball_query_calls(m, 8, 40960)] == [
        64, 32, 16, 16, 16, 16, 16]
    assert [(c["u"], c["c"], c["n"]) for c in counts.scatter_calls(
        m, 8, 40960)] == [
        (32768, 131, 2048), (8192, 259, 1024), (4096, 259, 512),
        (1536, 256, 256), (3072, 256, 512),
        (4096, 259, 1024), (4096, 259, 1024), (4096, 259, 1024),
        (256, 3, 1024)]
