"""The launch plan of the ball-query kernel (csrc/ball_query.cu) and a numpy
model of its scan, on the CPU.

The kernel runs only on the card, where chip_smoke.py holds it equal to
the plain version. Here `plan` (a pure function of B, N, M, K, the SM
count and the sorted tier's Z order) is pinned at every main-path
ball-query shape, and `model_scan`
repeats the kernel's steps: the pre-pass (points in scan order, NaN where
masked or past N; each 32-point tile's box of its valid points, +inf /
-inf where it has none), then per warp of C centers and per 32 tiles a
ballot of box tests (with the reference's slack) for each unfinished
center, and for each center, in index order, the tiles of its own ballot
(the kernel's three forms of a chunk, dense, sparse and centers apart,
differ in what they load and compute, not in which tiles a center's hits
come from): per tile the ballot of hits, the slot of each as the hits so
far plus the set lanes below it, the first hit from the first non-zero
ballot, the exit once every center holds K;
then the epilogue (pad with the first hit, 0 for an empty ball, cnt =
min(hits, K)), with the sorted tier's map-back (point perm[slot], row
perm_c[j]). The model must equal the reference's numpy oracle and the
plain version index for index.
"""

import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from test_torch_outdoor import _sorted_case
from tpu3dsad.ops.oracle import ball_query_oracle
from tpu3dsad_torch.ops import sorted as tsorted
from tpu3dsad_torch.ops.cuda import ball_query as cuda_bq
from tpu3dsad_torch.ops.cuda.ball_query import (
    CENTERS,
    MAX_WARPS,
    TILE,
    Plan,
    plan,
    scratch_floats,
    skip_radius_sq,
)
from tpu3dsad_torch.ops.plain import ball_query as plain_bq
from tpu3dsad_torch.ops.plain.ball_query import radius_sq

SMS = 132  # an H100 SXM

# (path, call) -> (B, N, M, K, sorted tier, plan on 132 SMs): the
# ball-query calls of a served request (config #5), a config-#3 train step
# and a config-#4 eval batch (the proposal's three bank radii share one
# shape), and the SA1 calls of the sorted tier
MAIN_PATH = {
    ("serve", "sa1"): (32, 20480, 2048, 64, False, Plan(16, 4, True)),
    ("serve", "sa2"): (32, 2048, 1024, 32, False, Plan(16, 4, True)),
    ("serve", "sa3"): (32, 1024, 512, 16, False, Plan(16, 4, True)),
    ("serve", "sa4"): (32, 512, 256, 16, False, Plan(16, 2, True)),
    ("serve", "bank"): (32, 1024, 256, 16, False, Plan(16, 2, True)),
    ("train", "sa1"): (8, 40960, 2048, 64, False, Plan(16, 4, True)),
    ("train", "sa2"): (8, 2048, 1024, 32, False, Plan(16, 2, True)),
    ("train", "sa3"): (8, 1024, 512, 16, False, Plan(16, 1, True)),
    ("train", "sa4"): (8, 512, 256, 16, False, Plan(16, 1, True)),
    ("train", "bank"): (8, 1024, 256, 16, False, Plan(16, 1, True)),
    ("eval4", "sa1"): (8, 16384, 2048, 64, False, Plan(16, 4, True)),
    ("eval4", "sa1 sorted"): (8, 16384, 2048, 64, True, Plan(16, 4, False)),
    ("serve", "sa1 sorted"): (32, 20480, 2048, 64, True, Plan(16, 4, False)),
    ("train", "sa1 sorted"): (8, 40960, 2048, 64, True, Plan(16, 4, False)),
}


def _check_plan(p):
    assert p.centers in CENTERS
    assert 1 <= p.warps <= MAX_WARPS
    assert isinstance(p.shared, bool)


@pytest.mark.parametrize("key", list(MAIN_PATH), ids="-".join)
def test_plan_of_every_main_path_shape(key):
    b, n, m, k, ordered, want = MAIN_PATH[key]
    got = plan(b, n, m, k, SMS, ordered=ordered)
    assert got == want
    _check_plan(got)


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("sms", [132, 114, 7])
@pytest.mark.parametrize("b,n,m,k", [(1, 1, 1, 1), (2, 40, 3, 64),
                                     (200, 512, 256, 16), (1, 122880, 16384, 64)])
def test_plan_is_a_kernel_instance(b, n, m, k, sms, ordered):
    got = plan(b, n, m, k, sms, ordered=ordered)
    _check_plan(got)
    assert got.shared != ordered
    assert b * m >= got.centers * 16 * sms or got.centers == 1


def test_scratch_and_threshold():
    """The pre-pass's scratch holds the staged points and the boxes; the
    box test's threshold is the reference's r2 * (1 + 1e-3), rounded to
    fp32 and never below r2."""
    assert scratch_floats(2, 33) == 2 * (3 * 64 + 6 * 2)
    assert scratch_floats(8, 40960) == 8 * (3 * 40960 + 6 * 1280)
    for r in (0.15, 0.2, 0.3, 0.4, 0.6, 0.8, 1.2, 1.6, 1e-3, 7.0):
        r2 = radius_sq(r)
        thr = skip_radius_sq(r2)
        assert np.float32(thr) == thr and thr >= r2
        assert thr == pytest.approx(r2 * 1.001, rel=1e-6)


# ------------------------------------------------ numpy model of the kernel


def _sum_sq(dx, dy, dz):
    """fp32 (dx*dx + dy*dy) + dz*dz, each operation rounded (no FMA)."""
    return (dx * dx + dy * dy) + dz * dz


def model_stage(xyz, mask, perm=None):
    """The pre-pass: points [T*32, 3] in scan order (NaN where masked or past
    N) and boxes lo, hi [T, 3] of each tile's valid points."""
    n = xyz.shape[0]
    tiles = -(-n // TILE)
    order = np.arange(n) if perm is None else perm
    valid = np.ones(n, bool) if mask is None else mask.astype(bool)
    pts = np.full((tiles * TILE, 3), np.nan, np.float32)
    pts[:n] = np.where(valid[order][:, None], xyz[order], np.nan)
    t = pts.reshape(tiles, TILE, 3)
    lo = np.where(np.isnan(t), np.inf, t).min(1).astype(np.float32)
    hi = np.where(np.isnan(t), -np.inf, t).max(1).astype(np.float32)
    return pts, lo, hi


def model_box_test(c, lo, hi, thr):
    """[T] bool: the tiles that may hold a point inside the ball around c."""
    zero = np.float32(0)
    sep = np.maximum(zero, np.maximum(lo - c, c - hi))
    return ~(_sum_sq(sep[:, 0], sep[:, 1], sep[:, 2]) > np.float32(thr))


def model_scan(xyz, centers, r, k, mask=None, centers_per_warp=1, perm=None,
               perm_c=None):
    """One cloud as ball_query_kernel<C> computes it: (idx [M, K], cnt [M],
    tiles scanned per center, box tests per center)."""
    m = centers.shape[0]
    pts, lo, hi = model_stage(xyz, mask, perm)
    tiles = lo.shape[0]
    r2 = np.float32(radius_sq(r))
    thr = skip_radius_sq(r2)
    pid = (lambda p: p) if perm is None else (lambda p: int(perm[p]))
    idx = np.full((m, k), -1, np.int64)
    cnt = np.zeros(m, np.int64)
    scanned = np.zeros(m, np.int64)
    tested = np.zeros(m, np.int64)
    lanes = np.arange(TILE)
    for j0 in range(0, m, centers_per_warp):
        rows = range(j0, min(j0 + centers_per_warp, m))
        src = [j if perm_c is None else int(perm_c[j]) for j in rows]
        hits = {j: 0 for j in src}
        first = {j: 0 for j in src}
        done = False
        for t0 in range(0, tiles, TILE):
            if done:
                break
            chunk = slice(t0, min(t0 + TILE, tiles))
            need = {}  # each center's ballot of the tiles it may hit in
            for j in src:
                need[j] = np.zeros(chunk.stop - t0, bool)
                if hits[j] < k:
                    need[j] = model_box_test(centers[j], lo[chunk], hi[chunk],
                                             thr)
                    tested[j] += need[j].size
            for t in t0 + np.nonzero(np.any(list(need.values()), 0))[0]:
                p = pts[t * TILE:(t + 1) * TILE]
                for j in src:
                    if not need[j][t - t0]:
                        continue
                    scanned[j] += 1
                    d = centers[j] - p
                    hit = _sum_sq(d[:, 0], d[:, 1], d[:, 2]) < r2
                    if hit.any() and hits[j] < k:
                        slot = hits[j] + np.cumsum(hit) - hit  # set lanes below
                        for lane in lanes[hit & (slot < k)]:
                            idx[j, slot[lane]] = pid(t * TILE + lane)
                        if hits[j] == 0:
                            first[j] = t * TILE + int(np.argmax(hit))
                        hits[j] += int(hit.sum())
                        if hits[j] >= k:
                            need[j][:] = False
                if all(h >= k for h in hits.values()):
                    done = True
                    break
        for j in src:
            c = min(hits[j], k)
            idx[j, c:] = pid(first[j]) if hits[j] else 0
            cnt[j] = c
    assert (idx >= 0).all(), "a slot below cnt was not written"
    return idx, cnt, scanned, tested


def _bq_case(kind):
    """(xyz [B, N, 3], centers [B, M, 3], mask or None, r, K) of one edge
    case of the scan."""
    rng = np.random.default_rng(53)
    B, N, M = 2, 700, 40
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    centers = xyz[:, :M].copy()
    mask, r, K = None, 0.3, 16
    if kind == "ties":  # an integer grid: duplicates and equal distances
        xyz = rng.integers(-2, 3, (B, N, 3)).astype(np.float32)
        centers = xyz[:, :M].copy()
        r, K = 1.5, 24
    elif kind == "boundary":  # d2 == r2 exactly, and one ulp inside
        r, K = 0.5, 64  # r2 = 0.25 in fp32 and in the oracle's float64
        on = np.float32(0.5)
        inside = np.nextafter(on, np.float32(0))
        xyz[:, :350] = [3, 3, 3]
        xyz[:, 0:350:3] = [on, 0, 0]
        xyz[:, 1:350:3] = [0, -inside, 0]
        centers[:, :20] = 0
        zero = np.float32(0)
        assert _sum_sq(on, zero, zero) == np.float32(radius_sq(r))
        assert _sum_sq(inside, zero, zero) < np.float32(radius_sq(r))
    elif kind == "box_edge":  # centers at a tile box's faces +- r
        xyz[:, :, 2] = np.sort(xyz[:, :, 2], axis=1)  # tiles banded in z
        r = 0.1
        tops = xyz[:, TILE - 1::TILE, 2]  # each tile's hi z
        for b in range(B):
            for i in range(M):
                t = i % tops.shape[1]
                step = (-1.0005, -0.9995, 0.0, 0.9995, 1.0005)[i % 5]
                centers[b, i] = [0.0, 0.0, tops[b, t] + np.float32(step * r)]
    elif kind == "masked_tiles":  # whole tiles masked; cloud 1 all masked
        mask = rng.random((B, N)) < 0.6
        mask[0, 64:160] = False
        mask[0, 320:] = mask[0, 320:] & (np.arange(320, N) % 64 < 32)
        mask[1] = False
    elif kind == "ragged":  # N % 32 != 0, a masked tail
        xyz, centers = xyz[:, :650], centers[:, :33]
        mask = np.ones((B, 650), bool)
        mask[:, 640:] = False
    elif kind == "k_gt_n":
        xyz, r, K = xyz[:, :45], 2.0, 64
    elif kind == "empty_saturated":  # far centers; dense balls
        centers[:, 20:] += 10.0
        r, K = 0.8, 32
    elif kind == "sorted":  # spatially ordered: most tiles skip
        xyz = xyz[np.arange(B)[:, None], np.argsort(xyz[:, :, 0], axis=1)]
        centers = xyz[:, rng.integers(0, N, M)]
        r, K = 0.05, 32
    return (np.ascontiguousarray(xyz), np.ascontiguousarray(centers), mask, r,
            K)


CASES = ["random", "ties", "boundary", "box_edge", "masked_tiles", "ragged",
         "k_gt_n", "empty_saturated", "sorted"]


@pytest.mark.parametrize("centers_per_warp", CENTERS)
@pytest.mark.parametrize("kind", CASES)
def test_model_of_the_scan_equals_oracle_and_plain(kind, centers_per_warp):
    xyz, centers, mask, r, K = _bq_case(kind)
    tm = None if mask is None else torch.from_numpy(mask)
    pi, pc = plain_bq(torch.from_numpy(xyz), torch.from_numpy(centers), r, K,
                      mask=tm)
    skipped = []
    for b in range(xyz.shape[0]):
        mb = None if mask is None else mask[b]
        idx, cnt, scanned, tested = model_scan(xyz[b], centers[b], r, K, mb,
                                               centers_per_warp)
        oi, oc = ball_query_oracle(xyz[b], centers[b], r, K, mb)
        np.testing.assert_array_equal(idx, oi, err_msg=f"oracle b={b}")
        np.testing.assert_array_equal(cnt, oc, err_msg=f"oracle b={b}")
        np.testing.assert_array_equal(idx, pi[b].numpy(), err_msg=f"plain b={b}")
        np.testing.assert_array_equal(cnt, pc[b].numpy(), err_msg=f"plain b={b}")
        skipped.append(1 - scanned.sum() / max(tested.sum(), 1))
    if kind == "boundary":  # the ulp inside joins, the point on r2 does not
        assert (pc[:, :20] == K).all()
        assert not np.isin(np.arange(0, 350, 3), pi[:, :20].numpy()).any()
    elif kind == "masked_tiles":
        assert (pc[1] == 0).all() and (pi[1] == 0).all()
    elif kind == "empty_saturated":
        assert (pc[:, 20:] == 0).all() and (pc[:, :20] == K).any()
    elif kind == "sorted" and centers_per_warp == 1:
        assert min(skipped) > 0.8, skipped


def test_box_test_is_conservative_at_the_edge():
    """A tile whose nearest face lies exactly r (or a float32 ulp less)
    from the center is scanned; one more than r * 1.001 away is skipped."""
    lo = np.array([[0.0, 0.0, 0.0]], np.float32)
    hi = np.array([[1.0, 1.0, 1.0]], np.float32)
    r = 0.25
    r2 = np.float32(radius_sq(r))
    thr = skip_radius_sq(r2)
    near = np.float32(np.sqrt(r2))
    for x, want in ((1 + near, True), (np.nextafter(1 + near, 0), True),
                    (-near, True), (1 + np.float32(r * 1.01), False),
                    (-np.float32(r * 1.01), False), (0.5, True)):
        c = np.array([x, 0.5, 0.5], np.float32)
        assert model_box_test(c, lo, hi, thr)[0] == want, (x, want)
    # an empty tile (no valid point) is always skipped
    empty_lo = np.full((1, 3), np.inf, np.float32)
    assert not model_box_test(np.zeros(3, np.float32), empty_lo, -empty_lo,
                              thr)[0]


@pytest.mark.parametrize("centers_per_warp", CENTERS)
@pytest.mark.parametrize("kind", ["clustered", "masked_junk",
                                  "empty_and_saturated"])
def test_model_of_the_fused_map_back_equals_sorted_map_back(kind,
                                                           centers_per_warp):
    """The scan on the Z-order permutations, with the map-back in its
    epilogue, equals sorted_views + plain + map_back (the plain sorted
    tier); masked points are NaN in the pre-pass where the glue moves them
    to 1e9."""
    xyz, centers, mask, r, K = _sorted_case(kind)
    tm = None if mask is None else torch.from_numpy(mask)
    tx, tc = torch.from_numpy(xyz), torch.from_numpy(centers)
    xs, cs, perm, inv_c = tsorted.sorted_views(tx, tc, tm)
    want_i, want_c = tsorted.map_back(*plain_bq(xs, cs, r, K), perm, inv_c)
    got_i, got_c = tsorted.sorted_ball_query(tx, tc, r, K, mask=tm)
    assert torch.equal(got_i, want_i) and torch.equal(got_c, want_c)
    perm_c = torch.argsort(inv_c, dim=1)  # row j of the view: center perm_c[j]
    assert torch.equal(torch.gather(tc, 1, perm_c[..., None].expand_as(tc)), cs)
    for b in range(xyz.shape[0]):
        mb = None if mask is None else mask[b]
        idx, cnt, _, _ = model_scan(xyz[b], centers[b], r, K, mb,
                                    centers_per_warp, perm[b].numpy(),
                                    perm_c[b].numpy())
        np.testing.assert_array_equal(idx, want_i[b].numpy(), err_msg=f"b={b}")
        np.testing.assert_array_equal(cnt, want_c[b].numpy(), err_msg=f"b={b}")


def test_sorted_kernel_path_hands_the_scan_its_permutations(monkeypatch):
    """The sorted tier's kernel path (z_order: the codes, then stable sorts;
    the scan given perm and perm_c), with the two kernels replaced by the
    plain codes and the numpy model of the scan, equals the plain path, and
    counts one sorted call."""
    from tpu3dsad_torch import ops

    xyz, centers, mask, r, K = _sorted_case("masked_junk")
    tx, tc, tm = (torch.from_numpy(a) for a in (xyz, centers, mask))
    want = tsorted.sorted_ball_query(tx, tc, r, K, mask=tm)

    def model_kernel(x, c, radius, k, mk=None, *, perm, perm_c):
        outs = [model_scan(x[b].numpy(), c[b].numpy(), radius, k,
                           mk[b].numpy(), 2, perm[b].numpy(),
                           perm_c[b].numpy())[:2] for b in range(x.shape[0])]
        return tuple(torch.from_numpy(np.stack(o)).int() for o in zip(*outs))

    monkeypatch.setattr(cuda_bq, "morton_codes", tsorted.z_keys)
    monkeypatch.setattr(cuda_bq, "ball_query", model_kernel)
    monkeypatch.setattr(ops, "_use_kernel", lambda t: True)
    monkeypatch.setattr(tsorted, "launches", 0)
    got = tsorted.sorted_ball_query(tx, tc, r, K, mask=tm)
    assert tsorted.launches == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
