"""The primitives that decide whether a check of chip_smoke.py passes on
the card (exact equality of integer tensors, the bits of float tensors,
the host scatter the kernel is held to, a scatter's longest row, the FPS
templates' spills in the ptxas log) and the kernel times of a profiler
trace by which its phase 12 counts a replayed step's kernels, on the CPU
with hand-made inputs; and what phase 19 holds 3DSSD to: its launches a
request against the ops of a CPU serve, its feature-FPS inputs."""

import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from chip_smoke import (
    BOX_POINTS_CASES,
    FFPS_CASES,
    GROUPFREE_REQUEST,
    SSD3D_REQUEST,
    add_at,
    bits_differ,
    box_points_input,
    ffps_input,
    fps_templates,
    kernel_times,
    longest_row,
    require_equal,
)


def test_kernel_times_sums_by_name_most_time_first():
    events = [{"cat": "kernel", "name": "a", "ts": 0, "dur": 3},
              {"cat": "kernel", "name": "b", "ts": 5, "dur": 10},
              {"cat": "kernel", "name": "a", "ts": 20, "dur": 4},
              {"cat": "cpu_op", "name": "b", "ts": 0, "dur": 99}]
    assert kernel_times(events) == [("b", 10.0, 1), ("a", 7.0, 2)]


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.uint8])
def test_require_equal_returns_0_on_equal_ints(dtype):
    got = torch.arange(24, dtype=dtype).reshape(2, 3, 4)
    assert require_equal("idx", got, got.clone()) == 0


def test_require_equal_names_the_first_differing_index():
    want = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4)
    got = want.clone()
    got[1, 2, 0] = -7
    with pytest.raises(AssertionError,
                       match=r"idx: kernel != plain at \(1, 2, 0\): kernel "
                             r"-7 plain 20 \(1 entries differ\)"):
        require_equal("idx", got, want)


def test_require_equal_refuses_another_shape():
    with pytest.raises(AssertionError, match=r"cnt: shape \(2, 3\) vs "
                                             r"\(3, 2\)"):
        require_equal("cnt", torch.zeros(2, 3, dtype=torch.int32),
                      torch.zeros(3, 2, dtype=torch.int32))


def test_require_equal_on_bool_masks():
    keep = torch.tensor([[True, False, True], [False, False, True]])
    assert require_equal("keep", keep, keep.clone()) == 0
    other = keep.clone()
    other[0, 1] = True
    with pytest.raises(AssertionError, match=r"at \(0, 1\)"):
        require_equal("keep", other, keep)


@pytest.mark.parametrize("got, want", [
    # through int64, 0.25 and 0.5 both truncate to 0 and would pass
    (torch.tensor([0.25, 1.0]), torch.tensor([0.5, 1.0])),
    (torch.tensor([1, 2], dtype=torch.int32), torch.tensor([1.0, 2.0])),
], ids=["float", "float beside int"])
def test_require_equal_refuses_floats(got, want):
    with pytest.raises(TypeError, match="integer or bool"):
        require_equal("iou", got, want)


_ONE_ULP = float(np.nextafter(np.float32(1.0), np.float32(2.0)))


@pytest.mark.parametrize("a, b, want", [
    ([1.5, -2.0, 3.0], [1.5, -2.0, 3.0], None),
    ([1.0, 0.0], [1.0, -0.0], "at (1,): 0.0 vs -0.0 (1 entries differ)"),
    ([1.0, 2.0], [_ONE_ULP, 2.0],
     f"at (0,): 1.0 vs {_ONE_ULP!r} (1 entries differ)"),
    ([float("nan"), 4.0], [float("nan"), 4.0], None),
], ids=["equal", "signed zero", "one ulp", "same NaN"])
def test_bits_differ(a, b, want):
    assert bits_differ(torch.tensor(a), torch.tensor(b)) == want


def test_bits_differ_tells_nan_payloads_apart():
    quiet = torch.tensor([0x7FC00000], dtype=torch.int32).view(torch.float32)
    other = torch.tensor([0x7FC00001], dtype=torch.int32).view(torch.float32)
    assert bits_differ(quiet, quiet.clone()) is None
    assert bits_differ(quiet, other).endswith("(1 entries differ)")


@pytest.mark.parametrize("seed", [0, 1])
def test_add_at_sums_in_index_order_dropping_out_of_range(seed):
    rng = np.random.default_rng(seed)
    b, u, c, n = 3, 200, 5, 7
    g = torch.from_numpy(rng.standard_normal((b, u, c)).astype(np.float32)
                         * np.float32(1e3))
    idx = torch.from_numpy(rng.integers(-1, n + 2, (b, u)).astype(np.int32))
    want = np.zeros((b, n, c), np.float32)
    for i in range(b):
        for j in range(u):
            row = int(idx[i, j])
            if 0 <= row < n:
                for k in range(c):
                    want[i, row, k] = np.float32(want[i, row, k]
                                                 + g[i, j, k].numpy())
    got = add_at(g, idx, n)
    assert got.dtype == torch.float32 and got.shape == (b, n, c)
    assert bits_differ(got, torch.from_numpy(want)) is None


def test_longest_row_counts_each_cloud_apart():
    # cloud 0: row 2 twice, row 0 once, -1 and 4 dropped; cloud 1: row 2
    # twice, row 3 once, 9 dropped. Rows of two clouds never add up.
    idx = torch.tensor([[2, 0, 2, -1, 4], [2, 3, 2, 9, 1]], dtype=torch.int32)
    assert longest_row(idx, 4) == 2
    idx[1, 4] = 2
    assert longest_row(idx, 4) == 3


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118fps_cluster_kernelILi0EEEvPKfPKbPfPiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118fps_cluster_kernelILi0EEEvPKfPKbPfPiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 2112 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113stage_kernelEPKfPKbPfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113stage_kernelEPKfPKbPfiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118fps_cluster_kernelILi16EEEvPKfPKbPfPiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118fps_cluster_kernelILi16EEEvPKfPKbPfPiiiii
    16 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 168 registers, 2112 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125fps_cluster_kernel_prunedILi16EEEvPKfPKhPKiPiiiPy' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125fps_cluster_kernel_prunedILi16EEEvPKfPKhPKiPiiiPy
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 118 registers, 2112 bytes smem, 408 bytes cmem[0]
"""


def test_fps_templates_reads_registers_and_spills():
    assert fps_templates(PTXAS_LOG) == {
        ("fps_cluster_kernel", 0): (40, 0),
        ("fps_cluster_kernel", 16): (168, 32),
        ("fps_cluster_kernel_pruned", 16): (118, 0)}
    assert fps_templates("") == {}


def test_ssd3d_request_launches_are_the_ops_of_a_cpu_serve():
    """Phase 19's launches a 3DSSD request, counted here as calls of the
    custom ops (each kernel wrapper launches once a call) in one request
    of preset=3dssd at a small size: the same samplers, groupings and NMS
    as at the cell's size."""
    from tpu3dsad_torch import serving, train_lib
    from tpu3dsad_torch.config import parse_cli
    from tpu3dsad_torch.ops import library
    from tpu3dsad_torch.train_detector import build_detector

    cfg = parse_cli(["preset=3dssd",
                     "model.ssd3d_npoints=((512,),(64,),(32,32))",
                     "model.ssd3d_fps_ranges=((-1,),(-1,),(64,-1))",
                     "data.num_points=2048"])
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg, device="cpu")
    ops = {"fps": "fps", "ffps": "ffps", "ball_query": "ball_query",
           "iou": "oriented_bev_iou", "nms": "greedy_suppress"}
    calls = dict.fromkeys(ops, 0)
    saved = {k: getattr(library, op) for k, op in ops.items()}

    def counted(key):
        def call(*args, **kwargs):
            calls[key] += 1
            return saved[key](*args, **kwargs)
        return call

    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform([0, -20, -2], [40, 20, 1],
                                       (2, 2048, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.random((2, 2048, 1)).astype(np.float32))
    mask = torch.ones(2, 2048, dtype=torch.bool)
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes,
                                       with_features=True)
    for key, op in ops.items():
        setattr(library, op, counted(key))
    try:
        infer(pts, mask, feats)
    finally:
        for key, op in ops.items():
            setattr(library, op, saved[key])
    assert calls == SSD3D_REQUEST


@pytest.mark.parametrize("case", FFPS_CASES, ids=[c[0] for c in FFPS_CASES])
def test_ffps_input_makes_each_case(case):
    """Phase 19's feature-FPS inputs: the shape asked for, finite values,
    and the mask each kind names (none, a tail of 300, every other block
    of 512, all masked)."""
    name, b, n, d, m, kind = case
    x, mask = ffps_input(kind, b, n, d, torch.Generator().manual_seed(0))
    assert x.shape == (b, n, d) and x.dtype == torch.float32
    assert torch.isfinite(x).all() and m <= n
    at = torch.arange(n)
    want = {"tail": at < n - 300, "slices": at // 512 % 2 == 0,
            "all": torch.zeros(n, dtype=torch.bool)}.get(kind)
    if want is None:
        assert mask is None
    else:
        assert torch.equal(mask, want[None].expand(b, n))
    if kind == "cell":
        assert (x[..., :3] >= 0).all() and (x[..., :3] <= 40).all()
        assert (x[..., 3:] >= 0).all()
    if kind == "grid":
        assert set(x.unique().tolist()) <= {0.0, 1.0, 2.0}


def test_groupfree_request_launches_are_the_ops_of_a_cpu_serve():
    """Phase 21's launches a Group-Free request, counted here as calls of
    the custom ops in one request of preset=groupfree3d at a small size:
    the same set abstractions, point count and walk as at the cell's
    size, and no FPS for the candidates."""
    from tpu3dsad_torch import serving, train_lib
    from tpu3dsad_torch.config import parse_cli
    from tpu3dsad_torch.ops import library
    from tpu3dsad_torch.train_detector import build_detector

    cfg = parse_cli(["preset=groupfree3d",
                     "model.sa_npoints=(256,64,32,16)",
                     "model.groupfree_candidates=16",
                     "model.groupfree_layers=2", "data.num_points=1024"])
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg, device="cpu")
    ops = {"fps": "fps", "ffps": "ffps", "ball_query": "ball_query",
           "iou": "oriented_bev_iou", "box_points": "box_points",
           "nms": "greedy_suppress"}
    calls = dict.fromkeys(ops, 0)
    saved = {k: getattr(library, op) for k, op in ops.items()}

    def counted(key):
        def call(*args, **kwargs):
            calls[key] += 1
            return saved[key](*args, **kwargs)
        return call

    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-3, 3, (2, 1024, 3))
                           .astype(np.float32))
    mask = torch.ones(2, 1024, dtype=torch.bool)
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes)
    for key, op in ops.items():
        setattr(library, op, counted(key))
    try:
        out = infer(pts, mask)
    finally:
        for key, op in ops.items():
            setattr(library, op, saved[key])
    assert {k: v for k, v in calls.items() if v} == GROUPFREE_REQUEST
    assert out["keep"].shape == (2, 48)


@pytest.mark.parametrize("case", [c for c in BOX_POINTS_CASES
                                  if c[2] * c[3] <= 4097],
                         ids=lambda c: c[0])
def test_box_points_input_makes_each_case(case):
    """Phase 21's point-count inputs: the shapes asked for, finite values,
    the mask each kind names, and on "faces" the first six points of each
    cloud on the six faces of its first box, to the rounding of centre +
    half size."""
    name, b, n, p, kind = case
    pts, c, s, mask = box_points_input(kind, b, n, p,
                                       torch.Generator().manual_seed(0))
    assert pts.shape == (b, n, 3) and c.shape == s.shape == (b, p, 3)
    assert all(torch.isfinite(t).all() for t in (pts, c, s))
    at = torch.arange(n)
    want = {"tail": at < n * 3 // 4,
            "all": torch.zeros(n, dtype=torch.bool)}.get(kind)
    if want is None:
        assert mask is None
    else:
        assert torch.equal(mask, want[None].expand(b, n))
    if kind == "faces":
        gap = (pts[:, :6] - c[:, :1]).abs()
        half = (s[:, :1] * 0.5).abs().expand(b, 6, 3)
        face = torch.eye(3, dtype=torch.bool).repeat_interleave(2, 0)
        torch.testing.assert_close(gap[:, face], half[:, face], rtol=0,
                                   atol=1e-6)
        assert (gap[:, ~face] == 0).all()
