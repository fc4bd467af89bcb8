"""The launch plan of the FPS kernel template (csrc/fps.cu) and a numpy
model of its sliced reduction and of B2's pruned pass, on the CPU.

The kernel runs only on the card, where chip_smoke.py holds it equal to
the plain version. Here `plan` (a pure function of B, N and the SM count)
is pinned at every main-path FPS shape, the pruned pass's pre-pass
(`deal`: Z-order keys to slabs) is pinned against numpy, and
`tests/fps_model.py::model_fps` repeats the kernel's arithmetic stage by
stage, pruned or not. The model must equal the reference's numpy oracle
and the plain version pick for pick; where a valid point has a NaN
coordinate (the kernel's fminf keeps its distance, the plain version's
torch.minimum takes the NaN in, before any pruning), the pruned model is
held to the unpruned one.
"""

import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from portbench.traffic import outdoor as traffic
from fps_model import model_fps, slabs
from tpu3dsad.ops.oracle import fps_oracle
from tpu3dsad_torch.data import kitti
from tpu3dsad_torch.ops.cuda import fps as cuda_fps
from tpu3dsad_torch.ops.cuda.fps import MAX_CLUSTER, SLAB, Plan, deal, plan
from tpu3dsad_torch.ops.plain import furthest_point_sample as plain_fps
from tpu3dsad_torch.ops.sorted import z_keys

SMS = 132  # an H100 SXM

# (path, call) -> (B, N, first plan on 132 SMs): the 5 FPS calls of a
# served request, a config-#3 train step and a config-#4 eval batch, and a
# config-#4 scene (122880 raw points, cropped, padded to 4096s)
MAIN_PATH = {
    ("serve", "sa1"): (32, 20480, Plan(4, 320, 16)),
    ("serve", "sa2"): (32, 2048, Plan(4, 64, 8)),
    ("serve", "sa3"): (32, 1024, Plan(4, 128, 2)),
    ("serve", "sa4"): (32, 512, Plan(4, 128, 1)),
    ("serve", "proposal"): (32, 1024, Plan(4, 128, 2)),
    ("train", "sa1"): (8, 40960, Plan(8, 320, 16)),
    ("train", "sa2"): (8, 2048, Plan(8, 128, 2)),
    ("train", "sa3"): (8, 1024, Plan(8, 128, 1)),
    ("train", "sa4"): (8, 512, Plan(4, 128, 1)),
    ("train", "proposal"): (8, 1024, Plan(8, 128, 1)),
    ("eval4", "sa1"): (8, 16384, Plan(8, 128, 16)),
    ("eval4", "sa2"): (8, 2048, Plan(8, 128, 2)),
    ("eval4", "sa3"): (8, 1024, Plan(8, 128, 1)),
    ("eval4", "sa4"): (8, 512, Plan(4, 128, 1)),
    ("eval4", "proposal"): (8, 1024, Plan(8, 128, 1)),
    ("eval4", "scene"): (1, 118784, Plan(16, 480, 16)),
}


def _check_candidates(b, n, sms, plans):
    assert plans, "no candidate"
    sizes = [p.cluster for p in plans]
    assert sizes == sorted(set(sizes), reverse=True)
    assert len({p.points == 0 for p in plans}) == 1, "tiers mixed"
    for p in plans:
        assert 1 <= p.cluster <= MAX_CLUSTER
        assert b * p.cluster <= max(sms, b), "more CTAs than SMs"
        assert p.threads % 32 == 0 and 32 <= p.threads <= 1024
        if p.points:
            assert p.threads <= cuda_fps.REGISTER_TIERS[p.points]
            assert p.cluster * p.threads * p.points >= n, "N not covered"


@pytest.mark.parametrize("key", list(MAIN_PATH), ids="-".join)
def test_plan_of_every_main_path_shape(key):
    b, n, first = MAIN_PATH[key]
    plans = plan(b, n, SMS)
    assert plans[0] == first
    assert first.tier.startswith("registers")
    _check_candidates(b, n, SMS, plans)


@pytest.mark.parametrize("sms", [132, 114, 66, 7])
@pytest.mark.parametrize("b,n", [(b, n) for b, n, _ in MAIN_PATH.values()]
                         + [(1, 65537), (1, 786432), (3, 20001), (200, 512),
                            (1, 1), (2, 40)])
def test_plan_covers_n_and_fits_the_card(b, n, sms):
    _check_candidates(b, n, sms, plan(b, n, sms))


def test_plan_of_large_clouds():
    """A cloud of up to 65536 points fits a portable cluster of 8 in
    registers; every bucketed config-#4 crop above it (4096s up to the raw
    122880) and N = 65537 keep the register tier on a non-portable cluster
    of 16; N = 786432 (the reference's largest flat cloud) takes the memory
    tier."""
    assert plan(1, 65536, SMS) == [Plan(8, 512, 16)]
    for n in range(69632, 122881, 4096):
        first = plan(1, n, SMS)[0]
        assert (first.cluster, first.points) == (16, 16)
    assert plan(1, 65537, SMS)[0] == Plan(16, 288, 16)
    assert plan(1, 786432, SMS) == [Plan(c, 1024, 0) for c in range(16, 0, -1)]


def test_plan_steps_down_to_smaller_clusters():
    """Where B clusters of the first size do not fit in one wave, the C
    entry takes the next candidate: B = 8 at N = 40960 can step from 8
    CTAs a cloud down to 5 while P stays in a register tier."""
    plans = plan(8, 40960, SMS)
    assert [p.cluster for p in plans] == [8, 7, 6, 5]
    assert plans[-1] == Plan(5, 512, 16)


# ------------------------------------------- numpy model of the kernel


def _case(kind):
    """(xyz [B, N, 3], mask or None, M, plan): the plan's real C, T, P
    unless the case forces one to leave CTAs empty."""
    rng = np.random.default_rng(41)
    B, N, M = 2, 6000, 96
    xyz = rng.uniform(-2, 2, (B, N, 3)).astype(np.float32)
    mask, forced = None, None
    S = plan(B, N, SMS)[0].threads * plan(B, N, SMS)[0].points  # a slice
    if kind == "grid_ties":  # a grid repeated along N: ties across slices
        xyz = np.tile(rng.integers(-3, 4, (B, 1500, 3)), (1, 4, 1))
        xyz = xyz.astype(np.float32)
    elif kind == "masked_tail":
        mask = rng.random((B, N)) < 0.8
        mask[:, 5000:] = False
    elif kind == "masked_slice":  # CTAs 1 and 2: every point masked
        mask = np.ones((B, N), bool)
        mask[:, S:3 * S] = False
    elif kind == "all_masked":
        mask = np.zeros((B, N), bool)
    elif kind == "empty_ctas":  # N < C*T: CTA 1 partly, CTAs 2-3 empty
        xyz, forced = xyz[:, :1500], Plan(4, 1024, 1)
    elif kind == "empty_ctas_p2":  # slices of 512: CTAs 6-7 empty
        xyz, forced = xyz[:, :3000], Plan(8, 256, 2)
    elif kind == "memory_tier":  # S = 750: three strides of 256 a thread
        xyz, forced = xyz[:, :3000], Plan(4, 256, 0)
    elif kind == "memory_tier_empty_ctas":  # S = 3: CTAs 14-15 empty
        xyz, M, forced = xyz[:, :40], 40, Plan(16, 32, 0)
    elif kind == "scene":  # the config-#4 scene's plan, a masked tail
        B, N, M = 1, 118784, 24
        xyz = rng.uniform(-40, 40, (B, N, 3)).astype(np.float32)
        mask = np.ones((B, N), bool)
        mask[:, N - 2000:] = False
    xyz = np.ascontiguousarray(xyz)
    p = forced or plan(B, xyz.shape[1], SMS)[0]
    return xyz, mask, M, p


@pytest.mark.parametrize("kind", [
    "random", "grid_ties", "masked_tail", "masked_slice", "all_masked",
    "empty_ctas", "empty_ctas_p2", "memory_tier", "memory_tier_empty_ctas",
    "scene"])
def test_model_of_the_sliced_reduction_equals_oracle_and_plain(kind):
    xyz, mask, M, p = _case(kind)
    if p.points:
        assert p.cluster * p.threads * p.points >= xyz.shape[1]
    want = plain_fps(torch.from_numpy(xyz), M,
                     mask=None if mask is None else torch.from_numpy(mask))
    for b in range(xyz.shape[0]):
        mb = None if mask is None else mask[b]
        got, _ = model_fps(xyz[b], M, mb, p)
        np.testing.assert_array_equal(got, fps_oracle(xyz[b], M, mb),
                                      err_msg=f"oracle b={b} {p}")
        np.testing.assert_array_equal(got, want[b].numpy(),
                                      err_msg=f"plain b={b} {p}")
    if kind == "all_masked":
        assert (want == 0).all()


# ------------------------------------------- B2's pruned pass


@pytest.mark.parametrize("n", [1, 511, 512, 1300, 118784])
def test_deal_is_a_stable_z_order_sort_cut_into_ascending_slabs(n):
    """The pre-pass's permutation, a pure function of the keys: the wrapper's
    torch deal() equals the numpy one; every index once, the pad N after
    them; each slab of SLAB ascending and holding the next SLAB indices of
    the stable sort, so ties in the keys keep index order and masked points
    (key 1 << 30) fill the last slabs."""
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 64, n).astype(np.int32)  # many ties
    codes[rng.random(n) < 0.3] = 1 << 30
    got = deal(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, slabs(codes))
    assert got.dtype == np.int32 and len(got) == -(-n // SLAB) * SLAB
    np.testing.assert_array_equal(np.sort(got[:n]), np.arange(n))
    assert (got[n:] == n).all()
    cut = got.reshape(-1, SLAB)
    assert (np.diff(cut, axis=1) >= 0).all()
    stable = np.argsort(codes, kind="stable")
    for s, row in enumerate(cut):
        np.testing.assert_array_equal(
            row[row < n], np.sort(stable[s * SLAB:(s + 1) * SLAB]))


def test_pruned_layout_deals_slabs_round_robin_over_the_ctas():
    """Slab s to warp s div C of CTA s mod C, its element e to lane e mod 32
    as the thread's point e div 32: one point of each of the 4 slabs of a
    2-CTA plan of 2 warps, read back through the model's layout (a cloud
    whose x is its index, no ties)."""
    n = 2048
    order = np.arange(n, dtype=np.int32)[::-1].copy()  # any permutation
    p = Plan(2, 64, 16)
    xyz = np.zeros((n, 3), np.float32)
    xyz[:, 0] = np.arange(n)
    picks, engaged = model_fps(xyz, 3, None, p, order)
    np.testing.assert_array_equal(picks, fps_oracle(xyz, 3))
    # every warp runs the first round (each holds valid points); the
    # second's pick, x = 2047, lies in slab 0 (x 1536-2047, CTA 0's first
    # warp) and within slab 1's largest distance (x 1024-1535, CTA 1's
    # first warp); slabs 2 and 3 (the second warps) lie farther: skipped
    assert engaged == 4 + 2


def _pruned_case(kind):
    """(xyz [N, 3], mask or None, M, plan) of one pruned-pass case; plans
    of 4 CTAs x 4 warps (16 slabs) stand in for B2's 16 x 15 where the
    cloud is small."""
    rng = np.random.default_rng(23)
    N, M, p = 6000, 200, Plan(4, 128, 16)
    xyz = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    mask = None
    if kind == "scan":  # the KITTI cell's scan, cropped, in its own order
        scan = traffic.outdoor_scene(np.random.default_rng(5), 8192,
                                     max_objects=3)
        xyz = np.ascontiguousarray(scan[kitti.range_crop(scan), :3])
        M = 256
    elif kind == "grid_ties":  # exact duplicates, split across slabs
        xyz = np.tile(rng.integers(-3, 4, (1500, 3)), (4, 1))
        xyz = xyz.astype(np.float32)
        M = 96
    elif kind == "masked_slabs":  # masked points sort last: slabs 6-11
        mask = rng.random(N) < 0.9
        mask[3000:] = False
    elif kind == "nan_masked":  # NaN only where masked
        mask = np.ones(N, bool)
        mask[rng.choice(N, 700, replace=False)] = False
        xyz[~mask] = np.nan
    elif kind == "pads":  # 3 slabs of 16 warps, 436 pads in the third
        xyz, M = xyz[:1100], 120
    elif kind == "all_masked":
        mask, M = np.zeros(N, bool), 16
    elif kind == "scene":  # B2's plan at the cell's padded size
        N, M = 118784, 24
        xyz = rng.uniform(-40, 40, (N, 3)).astype(np.float32)
        mask = np.ones(N, bool)
        mask[N - 2000:] = False
        p = plan(1, N, SMS)[0]
    return np.ascontiguousarray(xyz), mask, M, p


def _order(xyz, mask):
    """The pre-pass on the CPU: the plain Z-order keys, dealt by numpy."""
    codes, _ = z_keys(torch.from_numpy(xyz)[None],
                      torch.from_numpy(xyz[:1])[None],
                      None if mask is None else torch.from_numpy(mask)[None])
    return slabs(codes[0].numpy())


@pytest.mark.parametrize("kind", [
    "random", "scan", "grid_ties", "masked_slabs", "nan_masked", "pads",
    "all_masked", "scene"])
def test_model_of_the_pruned_pass_equals_oracle_and_plain(kind):
    xyz, mask, M, p = _pruned_case(kind)
    assert p.points == cuda_fps.PRUNED_POINTS
    order = _order(xyz, mask)
    got, engaged = model_fps(xyz, M, mask, p, order)
    want = plain_fps(torch.from_numpy(xyz)[None], M, mask=None
                     if mask is None else torch.from_numpy(mask)[None])
    np.testing.assert_array_equal(got, fps_oracle(xyz, M, mask))
    np.testing.assert_array_equal(got, want[0].numpy())
    unpruned, every = model_fps(xyz, M, mask, p)
    np.testing.assert_array_equal(got, unpruned)
    assert every == (M - 1) * p.cluster * p.threads // 32
    assert engaged <= every
    if kind == "all_masked":
        assert engaged == 0 and (got == 0).all()
    if kind == "scan":  # the deal is what makes the skip bite
        _, unsorted = model_fps(xyz, M, mask, p,
                                slabs(np.zeros(len(xyz), np.int32)))
        print(f"scan: engaged {engaged / every:.3f} of warp-rounds, "
              f"{unsorted / every:.3f} in the scan's own order")
        assert engaged < unsorted / 2


@pytest.mark.parametrize("share", [0.001, 0.05])
def test_pruned_pass_with_nan_coordinates_equals_the_unpruned_kernel(share):
    """Valid points with a NaN coordinate: the kernel's fminf keeps their
    distance (the plain version's torch.minimum does not, pruned or not),
    and the box leaves the NaN out; the pruned model equals the unpruned
    one at the same plan and at B1's."""
    rng = np.random.default_rng(int(share * 1000))
    N, M, p = 6000, 150, Plan(4, 128, 16)
    xyz = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    hit = rng.random((N, 3)) < share / 3
    xyz[hit] = np.nan
    mask = rng.random(N) < 0.95
    got, _ = model_fps(xyz, M, mask, p, _order(xyz, mask))
    np.testing.assert_array_equal(got, model_fps(xyz, M, mask, p)[0])
    np.testing.assert_array_equal(
        got, model_fps(xyz, M, mask, plan(1, N, SMS)[0])[0])
