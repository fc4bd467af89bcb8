"""The launch plan of the row scatter-add kernel (csrc/scatter.cu) and a
numpy model of its order of summation, on the CPU.

The kernel runs only on the card, where chip_smoke.py holds it bitwise
equal to np.add.at. Here `plan` (a pure function of B, U, n, C and the SM
count) is pinned at the 9 scatter calls of a config-#3 training step, at
B = 8 and at B = 1 and 32, and `model_scatter` repeats the kernel's steps
for each CTA (rows a warp x warps rows of one cloud, dealt round robin):
the fills, in which warp w keeps the entries of its segment of u that
fall in the CTA's rows, in order, up to its region's capacity, a fill
ending at the first region that stopped short; and the sums, in which
each row's entries are taken from the regions in order (the list the
chunks are staged from) and summed from 0.0 in float32. The model must
equal np.add.at in float32 bit for bit (a sequential sum in index order)
in every case, rows of any length and fills that overflow included. How
the list is cut into chunks, and the channels into slices, changes no
sum's order, so the model does not take them.
"""

import numpy as np
import pytest
import torch

from tpu3dsad_torch.ops.cuda import scatter as cuda_scatter
from tpu3dsad_torch.ops.cuda.scatter import (
    MAX_BLOCKS,
    MAX_WARPS,
    ROWS,
    Plan,
    blocks,
    plan,
)

SMS = 132  # an H100 SXM
LIST = 2048  # entries of the kernel's shared list (kList)

# name -> (n, U, C): the scatter calls of one config-#3 training step, from
# ModelConfig (the proposal's three bank radii share one shape)
STEP = {
    "sa2 group": (2048, 1024 * 32, 131),
    "sa3 group": (1024, 512 * 16, 259),
    "sa4 group": (512, 256 * 16, 259),
    "bank group": (1024, 256 * 16, 259),
    "fp2 interpolate": (512, 1024 * 3, 256),
    "fp1 interpolate": (256, 512 * 3, 256),
    "proposal centers": (1024, 256, 3),
}
# name -> the plan of that step call on 132 SMs, at B = 1, 8 and 32
PLANS = {"sa2 group": Plan(16, 1), "sa3 group": Plan(16, 1),
         "sa4 group": Plan(16, 1), "bank group": Plan(16, 1),
         "fp2 interpolate": Plan(16, 1), "fp1 interpolate": Plan(16, 1),
         "proposal centers": Plan(16, 1)}


@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("name", list(STEP))
def test_plan_of_every_step_call(name, b):
    n, u, c = STEP[name]
    got = plan(b, u, n, c, SMS)
    assert got == PLANS[name]
    _check_plan(got, c)


def _check_plan(p, c):
    assert 1 <= p.warps <= MAX_WARPS
    assert 1 <= blocks(c, p.slices) <= MAX_BLOCKS
    # no slice is empty
    assert (p.slices - 1) * -(-c // p.slices) < c


@pytest.mark.parametrize("sms", [132, 114, 7])
@pytest.mark.parametrize("b,u,n,c", [(1, 1, 1, 1), (3, 100, 7, 47),
                                     (64, 4096, 2048, 131),
                                     (200, 10, 5, 3), (2, 50000, 6000, 289),
                                     (2, 50000, 60000, 1000)])
def test_plan_fits_the_kernel(b, u, n, c, sms):
    _check_plan(plan(b, u, n, c, sms), c)


# ------------------------------------------------------------ the model


def model_lists(idx, n, warps, span, cap):
    """{row: its entries of u in the order the kernel adds them}, and the
    number of fills, for one cloud's indices `idx`: K CTAs of `warps`
    warps and at most `span` rows, dealt round robin (CTA k rows k, k + K,
    ...), K the least power of two >= n / span, regions of `cap`
    entries."""
    u = len(idx)
    ctas = 1
    while span * ctas < n:
        ctas *= 2
    lists, fills = {}, 0
    for k in range(ctas):
        mine = (idx >= 0) & (idx < n) & (idx % ctas == k)
        lo, seg = 0, -(-u // warps)
        while lo < u:
            fills += 1
            # a fill covers warps segments; where none stops short, the
            # next covers the rest, else it starts where the first one that
            # did stopped, with segments as long as the part that fitted
            kept, nxt = [], min(lo + warps * seg, u)
            nseg = -(-(u - nxt) // warps)
            for w in range(warps):
                s_lo = min(lo + w * seg, u)
                s_hi = min(s_lo + seg, u)
                hits = s_lo + np.flatnonzero(mine[s_lo:s_hi])
                kept.append(hits[:cap])
                if len(hits) > cap:  # stops at its first hit not kept
                    nxt, nseg = int(hits[cap]), int(hits[cap]) - s_lo
                    break
            order = np.concatenate(kept)
            for r in range(k, n, ctas):
                lists.setdefault(r, []).extend(order[idx[order] == r])
            assert nxt > lo
            lo, seg = nxt, nseg
    return lists, fills


def model_scatter(g, idx, n, warps, cap):
    """out [B, n, C] float32 in the kernel's order of summation, at one
    slice of channels."""
    B, U, C = g.shape
    out = np.zeros((B, n, C), np.float32)
    for b in range(B):
        lists, _ = model_lists(idx[b].astype(np.int64), n, warps,
                               ROWS * warps, cap)
        for r, entries in lists.items():
            acc = np.zeros(C, np.float32)
            for j in entries:
                acc = acc + g[b, j]
            out[b, r] = acc
    return out


def add_at(g, idx, n):
    """np.add.at in float32: a sequential sum in index order."""
    B, U, C = g.shape
    out = np.zeros((B * n, C), np.float32)
    ok = (idx >= 0) & (idx < n)
    rows = (idx + np.arange(B)[:, None] * n)[ok]
    np.add.at(out, rows, g[ok])
    return out.reshape(B, n, C)


def ball_query_idx(rng, b, m, k, n, empty):
    """idx shaped like ball query's [B, M*K]: each center's hits in
    increasing order, its empty slots repeating the first hit, and a share
    `empty` of the centers with no hit at all (all zeros)."""
    idx = np.zeros((b, m, k), np.int32)
    for bi in range(b):
        for mi in range(m):
            if rng.random() < empty:
                continue
            hits = np.sort(rng.choice(n, rng.integers(1, k + 1),
                                      replace=False))
            idx[bi, mi, :len(hits)] = hits
            idx[bi, mi, len(hits):] = hits[0]
    return idx.reshape(b, m * k)


def _case(kind, rng):
    """(g, idx, n) of each case; g normal and scaled, fp32."""
    if kind.startswith("ball query"):
        c = int(kind.split("C=")[1])
        idx = ball_query_idx(rng, 2, 96, 16, 200, empty=0.2)
        n = 200
    elif kind == "-1 and >= n":
        c, n = 3, 64
        idx = rng.integers(-1, 70, (3, 1000)).astype(np.int32)
    elif kind == "collisions":  # every entry on 8 rows
        c, n = 131, 256
        idx = rng.integers(0, 8, (2, 3000)).astype(np.int32)
    elif kind == "row 0":  # masked centers: K zeros each
        c, n = 47, 128
        idx = rng.integers(0, n, (2, 2000)).astype(np.int32)
        idx[:, 500:1500] = 0
    else:  # interpolation: 3 neighbours a point
        c, n = 259, 100
        idx = rng.integers(0, n, (2, 600)).astype(np.int32)
    g = (8.0 * rng.standard_normal((*idx.shape, c))).astype(np.float32)
    return g, idx, n


CASES = ["ball query C=3", "ball query C=47", "ball query C=131",
         "ball query C=259", "-1 and >= n", "interpolate C=259",
         "collisions", "row 0"]
# (warps, region capacity): the kernel's shapes (capacity LIST / warps),
# and small regions that make the fills overflow
SHAPES = [(16, LIST // 16), (32, LIST // 32), (4, LIST // 4), (1, LIST),
          (16, 5), (3, 40)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("kind", CASES)
def test_model_equals_add_at_bitwise(kind, shape):
    g, idx, n = _case(kind, np.random.default_rng(CASES.index(kind)))
    np.testing.assert_array_equal(model_scatter(g, idx, n, *shape),
                                  add_at(g, idx, n), strict=True)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("kind", CASES)
def test_model_lists_are_a_stable_sort_by_row(kind, shape):
    _, idx, n = _case(kind, np.random.default_rng(CASES.index(kind)))
    warps, cap = shape
    for one in idx.astype(np.int64):
        lists, _ = model_lists(one, n, warps, ROWS * warps, cap)
        ok = np.flatnonzero((one >= 0) & (one < n))
        got = np.concatenate([lists[r] for r in range(n)]).astype(np.int64)
        np.testing.assert_array_equal(
            got, ok[np.argsort(one[ok], kind="stable")])


@pytest.mark.parametrize("kind,shape", [
    ("collisions", (16, 5)), ("collisions", (1, 64)), ("row 0", (16, 5)),
    ("ball query C=47", (3, 40))])
def test_model_fills_overflow(kind, shape):
    """Regions that overflow end a fill early, and the next ones start
    where it stopped: more fills than CTAs."""
    _, idx, n = _case(kind, np.random.default_rng(CASES.index(kind)))
    warps, cap = shape
    span = ROWS * warps
    lists, fills = model_lists(idx[0].astype(np.int64), n, warps, span, cap)
    ctas = 1 << max(0, (-(-n // span) - 1).bit_length())
    assert fills > ctas
    valid = (idx[0] >= 0) & (idx[0] < n)
    assert sum(map(len, lists.values())) == valid.sum()


def test_wrapper_takes_only_cuda_tensors():
    before = cuda_scatter.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_scatter.scatter_rows(torch.ones(1, 2, 3),
                                  torch.zeros(1, 2, dtype=torch.int32), 4)
    assert cuda_scatter.launches == before
