"""The launch plan of the FPS kernel template (csrc/fps.cu) and a numpy
model of its sliced reduction, on the CPU.

The kernel runs only on the card, where chip_smoke.py holds it equal to
the plain version. Here `plan` (a pure function of B, N and the SM count)
is pinned at every main-path FPS shape, and `model_fps` repeats the
kernel's arithmetic stage by stage: each thread's points in the order the
kernel gives them (register tier: r*S + k*T + t; memory tier: a stride of
T over the slice), the thread's best (order-preserving distance bits,
index), then the warp's, the CTA's and the cluster's by "max bits, then
min index among the holders of the max". The model must equal the
reference's numpy oracle and the plain version pick for pick.
"""

import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from tpu3dsad.ops.oracle import fps_oracle
from tpu3dsad_torch.ops.cuda import fps as cuda_fps
from tpu3dsad_torch.ops.cuda.fps import MAX_CLUSTER, Plan, plan
from tpu3dsad_torch.ops.plain import furthest_point_sample as plain_fps

SMS = 132  # an H100 SXM
NONE = np.uint32(0xFFFFFFFF)  # the index of an empty partial

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


def _ordered(d):
    """The kernel's order-preserving bits of float32 distances."""
    u = np.asarray(d, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _reduce(bits, idx, axis):
    """(max bits, min index among the entries that hold it) along axis:
    the two redux.sync reductions of a stage."""
    top = bits.max(axis=axis)
    held = bits == np.expand_dims(top, axis)
    return top, np.where(held, idx, NONE).min(axis=axis)


def model_fps(xyz, m, mask, p: Plan):
    """One cloud's picks as fps_cluster_kernel<p.points> makes them with
    p.cluster CTAs of p.threads threads: xyz [N, 3] float32."""
    n = xyz.shape[0]
    C, T, P = p
    valid = np.ones(n, bool) if mask is None else mask.astype(bool)
    if P:  # thread t of CTA r holds points r*S + k*T + t, k < P; S = T*P
        g = np.arange(C * T * P).reshape(C, P, T)
        present = np.ones(g.shape, bool)  # pads (g >= n) are -inf points
    else:  # thread t walks j = t, t + T, ... < S; S = ceil(N / C)
        S = -(-n // C)
        j = np.arange(-(-S // T))[:, None] * T + np.arange(T)
        g = np.arange(C)[:, None, None] * S + j
        present = (j < S) & (g < n)
    real = g < n
    pts = np.where(real[..., None], xyz[np.where(real, g, 0)], 0)
    pts = pts.astype(np.float32)
    d = np.where(real & valid[np.where(real, g, 0)], np.inf, -np.inf)
    d = d.astype(np.float32)
    picks, last = [0], xyz[0]
    for _ in range(1, m):
        diff = pts - last
        d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
              ) + diff[..., 2] * diff[..., 2]
        d = np.minimum(d, d2)
        # thread: its first point of the highest bits (strict > in order)
        bits = np.where(present, _ordered(d), 0).astype(np.uint32)
        k = bits.argmax(axis=1)[:, None]
        tb = np.take_along_axis(bits, k, 1)[:, 0]  # [C, T]
        tg = np.where(tb > 0, np.take_along_axis(g, k, 1)[:, 0], NONE)
        # warp (32 lanes), CTA (its warps), cluster (its CTAs)
        wb, wg = _reduce(tb.reshape(C, T // 32, 32),
                         tg.reshape(C, T // 32, 32).astype(np.uint32), 2)
        cb, cg = _reduce(wb, wg, 1)
        _, win = _reduce(cb, cg, 0)
        assert win < n, "a pad or an empty CTA won"
        picks.append(int(win))
        last = xyz[win]  # the winner's xyz travels with its CTA's partial
    return np.array(picks)


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
        got = model_fps(xyz[b], M, mb, p)
        np.testing.assert_array_equal(got, fps_oracle(xyz[b], M, mb),
                                      err_msg=f"oracle b={b} {p}")
        np.testing.assert_array_equal(got, want[b].numpy(),
                                      err_msg=f"plain b={b} {p}")
    if kind == "all_masked":
        assert (want == 0).all()
