"""The trace arithmetic of profile_port.py (busy share, kernel times, GEMM
names), on hand-made traces."""

import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from profile_port import busy_share, is_gemm, kernel_times


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


def test_kernel_times_sums_by_name_most_time_first():
    events = [{"cat": "kernel", "name": "a", "ts": 0, "dur": 3},
              {"cat": "kernel", "name": "b", "ts": 5, "dur": 10},
              {"cat": "kernel", "name": "a", "ts": 20, "dur": 4},
              {"cat": "cpu_op", "name": "b", "ts": 0, "dur": 99}]
    assert kernel_times(events) == [("b", 10.0, 1), ("a", 7.0, 2)]


@pytest.mark.parametrize("name, gemm", [
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32", True),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_128x128>", True),
    ("ampere_sgemm_128x64_nn", True),
    ("void at::native::elementwise_kernel<128, 2>", False),
    ("scatter_rows_kernel", False),
])
def test_is_gemm(name, gemm):
    assert is_gemm(name) is gemm
