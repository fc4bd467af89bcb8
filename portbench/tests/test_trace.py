"""The idle share is taken over the traced window's wall time: idle time
at the window's edges counts."""

import pytest

from portbench import harness


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    ev("user_annotation", "window", 1000.0, 1000.0),
    ev("user_annotation", "h2d", 1000.0, 100.0),
    ev("kernel", "before", 900.0, 50.0),  # ended before the window
    ev("kernel", "a", 1100.0, 100.0),
    ev("kernel", "b", 1150.0, 150.0),  # overlaps a: 1100-1300 busy
    ev("gpu_memcpy", "Memcpy HtoD", 1500.0, 100.0),
    ev("kernel", "a", 1900.0, 300.0),  # runs past the host range's end
]


def test_busy_is_the_union_clipped_to_the_window():
    assert harness.busy_seconds(EVENTS, 1000.0, 2000.0) == pytest.approx(
        (200 + 100 + 100) / 1e6)


def test_read_trace_counts_the_edges():
    t = harness.read_trace(EVENTS, 4, 8, {}, _Ctx(), 100.0)
    assert t.window_s == pytest.approx(1200 / 1e6)  # 1000 .. 2200
    assert t.busy_s == pytest.approx(600 / 1e6)
    assert t.kernels["a"] == (pytest.approx(400 / 1e6), 2)
    assert "before" not in t.kernels
    # longest first, each named by the innermost host range at its start;
    # the window's leading edge lies under "h2d"
    assert t.idle_gaps == [("window", pytest.approx(300 / 1e6)),
                           ("window", pytest.approx(200 / 1e6)),
                           ("h2d", pytest.approx(100 / 1e6))]
    idle = harness.metric_reader("sweep.device_idle_share").read(t)
    assert idle == pytest.approx(50.0)


class _Ctx:
    config = {"model": {}}
    workload = {"batch": 2, "budget": 16}
