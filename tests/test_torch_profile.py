"""The busy-share arithmetic of profile_port.py, on hand-made traces."""

import pytest

from profile_port import busy_share


def _kernels(*spans):
    return [{"cat": "kernel", "ts": s, "dur": d} for s, d in spans]


@pytest.mark.parametrize("events, want", [
    (_kernels((0, 10)), (1, 10.0, 10.0)),
    (_kernels((0, 10), (20, 10)), (2, 20.0, 30.0)),
    (_kernels((20, 10), (0, 10), (5, 10)), (3, 25.0, 30.0)),  # overlap
    (_kernels((0, 30), (5, 5)) + [{"cat": "cpu_op", "ts": 40, "dur": 50}],
     (2, 30.0, 30.0)),  # a nested kernel; host ops are not device time
])
def test_busy_share(events, want):
    assert busy_share(events) == want


def test_busy_share_needs_a_kernel():
    with pytest.raises(RuntimeError, match="no kernel"):
        busy_share([{"cat": "cpu_op", "ts": 0, "dur": 5}])
