"""The port's point-sharded ops (tpu3dsad_torch/parallel) held against the
JAX package's (tpu3dsad/parallel/point_sharded.py) and against the port's
own unsharded ops, on the CPU, with the cases of
tests/distributed/test_point_sharded.py and test_sharded_model_path.py.

The port's side runs on 4 gloo ranks started once for the file
(test_torch_parallel_workers.ops_ranks): a 1-D mesh ('points',) of all 4
and a 2 x 2 mesh ('data', 'points'). The JAX side runs here on its
8-device CPU mesh (tests/conftest.py), 1-D and 2 x 4.

Indices, counts and masks are equal. Floats are bitwise the port's
unsharded ops (shards partition N in order and every merge is exact), and
within the reference's atol 1e-6 of the JAX package's.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

import tpu3dsad.ops as jops
from tpu3dsad.parallel import make_mesh as jmesh
from tpu3dsad.parallel import point_sharded as jps
from tpu3dsad_torch import ops
from tpu3dsad_torch.config import Config, apply_overrides
from tpu3dsad_torch.parallel import launch, make_mesh, shard_batch

import test_torch_parallel_workers as workers

WORLD = 4
ATOL = 1e-6


def _cases():
    rng = np.random.default_rng(0)
    f32 = np.float32
    c = {}
    B, N, M, K = 2, 512, 40, 16
    c["bq"] = dict(xyz=rng.uniform(-1, 1, (B, N, 3)).astype(f32),
                   centers=rng.uniform(-1, 1, (B, M, 3)).astype(f32),
                   mask=rng.random((B, N)) < 0.9, r=0.45, k=K)
    xyz = rng.uniform(-1, 1, (1, 256, 3)).astype(f32)
    # 4 dense hits (more than K = 8 in the ball) and 2 empty balls
    c["bq_edge"] = dict(xyz=xyz, centers=np.concatenate(
        [xyz[:, :4], np.full((1, 2, 3), 40.0, f32)], 1), r=0.3, k=8)
    mask = np.ones((2, 512), bool)
    mask[:, 450:] = False
    c["fps"] = dict(xyz=rng.uniform(-1, 1, (2, 512, 3)).astype(f32), m=48,
                    mask=mask)
    c["knn"] = dict(q=rng.uniform(-1, 1, (2, 33, 3)).astype(f32),
                    s=rng.uniform(-1, 1, (2, 512, 3)).astype(f32), k=3,
                    mask=rng.random((2, 512)) < 0.85)
    c["group"] = dict(pts=rng.standard_normal((2, 512, 6)).astype(f32),
                      idx=rng.integers(0, 512, (2, 32, 8)).astype(np.int32))
    mask = np.ones((2, 512), bool)
    mask[:, 480:] = False
    c["qg"] = dict(xyz=rng.uniform(-2, 2, (2, 512, 3)).astype(f32),
                   feats=rng.standard_normal((2, 512, 4)).astype(f32),
                   mask=mask, m=32, r=0.5, k=16)
    mask = np.ones((1, 1024), bool)
    mask[:, 1000:] = False
    c["sa"] = dict(xyz=rng.uniform(-4, 4, (1, 1024, 3)).astype(f32),
                   feats=rng.standard_normal((1, 1024, 4)).astype(f32),
                   mask=mask, m=64, r=0.4, k=16)
    mask = np.ones((4, 512), bool)
    mask[:, 490:] = False
    c["hybrid_sa"] = dict(xyz=rng.uniform(-3, 3, (4, 512, 3)).astype(f32),
                          feats=rng.standard_normal((4, 512, 4)).astype(f32),
                          mask=mask, m=32, r=0.5, k=16)
    c["hybrid_knn"] = dict(q=rng.uniform(-1, 1, (2, 33, 3)).astype(f32),
                           s=rng.uniform(-1, 1, (2, 512, 3)).astype(f32),
                           k=3, mask=rng.random((2, 512)) < 0.85)
    return c


CASES = _cases()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results, in rank order."""
    init = tmp_path_factory.mktemp("rendezvous") / "file"
    return launch.spawn(workers.ops_ranks, WORLD, backend="gloo",
                        init_file=str(init), args=(CASES,))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _same_on_every_rank(ranks, key):
    """Rank 0's result of `key`, after checking every rank's is the same
    (a replicated result of a 1-D mesh)."""
    first = ranks[0][key]
    parts = first if isinstance(first, tuple) else (first,)
    for r in ranks[1:]:
        mine = r[key] if isinstance(first, tuple) else (r[key],)
        for got, want in zip(mine, parts):
            np.testing.assert_array_equal(got, want, err_msg=key)
    return first


def _equal(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


def _jax_mesh():
    return jmesh((-1,), ("points",))


def _jit(fn, *arrays):
    """fn(*arrays) of the JAX package, jitted (eager shard_map is ~7x
    slower here)."""
    return jax.jit(fn)(*(jnp.asarray(a) for a in arrays))


# ------------------------------------------------------------ ball query


def test_sharded_ball_query_matches_reference_and_unsharded(ranks):
    c = CASES["bq"]
    idx, cnt = _same_on_every_rank(ranks, "bq")
    want = ops.ball_query(_t(c["xyz"]), _t(c["centers"]), c["r"], c["k"],
                          mask=_t(c["mask"]), exact=True)
    _equal(idx, want[0])
    _equal(cnt, want[1])
    j = _jit(lambda x, y, m: jps.sharded_ball_query(
        x, y, c["r"], c["k"], _jax_mesh(), mask=m),
        c["xyz"], c["centers"], c["mask"])
    _equal(idx, j[0])
    _equal(cnt, j[1])


def test_sharded_ball_query_empty_and_overflow(ranks):
    c = CASES["bq_edge"]
    idx, cnt = _same_on_every_rank(ranks, "bq_edge")
    want = ops.ball_query(_t(c["xyz"]), _t(c["centers"]), c["r"], c["k"],
                          exact=True)
    _equal(idx, want[0])
    _equal(cnt, want[1])
    assert (cnt[0, 4:] == 0).all() and (idx[0, 4:] == 0).all()
    assert (cnt[0, :4] > 0).all()
    j = _jit(lambda x, y: jps.sharded_ball_query(x, y, c["r"], c["k"],
                                                 _jax_mesh()),
             c["xyz"], c["centers"])
    _equal(idx, j[0])
    _equal(cnt, j[1])


# ------------------------------------------------------------------- FPS


def test_sharded_fps_matches_reference_and_unsharded(ranks):
    c = CASES["fps"]
    got = _same_on_every_rank(ranks, "fps")
    _equal(got, ops.furthest_point_sample(_t(c["xyz"]), c["m"],
                                          mask=_t(c["mask"])))
    _equal(got, _jit(lambda x, m: jps.sharded_fps(x, c["m"], _jax_mesh(),
                                                  mask=m),
                     c["xyz"], c["mask"]))
    assert (got < 450).all()  # the masked tail is never picked


def test_sharded_fps_one_collective_per_pick(ranks):
    """The pick loop is latency-bound: one collective a pick (the packed
    [B, 5] record) and one before the loop for the seed's coordinates
    (test_point_sharded.py:58-71 reads the same from the lowered loop)."""
    for r in ranks:
        assert r["fps_calls"] == CASES["fps"]["m"]


# ------------------------------------------------------------------- kNN


def test_sharded_knn_matches_reference_and_unsharded(ranks):
    c = CASES["knn"]
    d2, idx = _same_on_every_rank(ranks, "knn")
    want_d2, want_idx = ops.knn(_t(c["q"]), _t(c["s"]), c["k"],
                                support_mask=_t(c["mask"]))
    _equal(idx, want_idx)
    _equal(d2, want_d2)
    jd2, jidx = _jit(lambda q, x, m: jps.sharded_knn(
        q, x, c["k"], _jax_mesh(), support_mask=m),
        c["q"], c["s"], c["mask"])
    _equal(idx, jidx)
    np.testing.assert_allclose(d2, np.asarray(jd2), atol=ATOL)


# -------------------------------------------------------------- grouping


def test_sharded_group_matches_reference_and_unsharded(ranks):
    c = CASES["group"]
    got = _same_on_every_rank(ranks, "group")
    _equal(got, ops.group(_t(c["pts"]), _t(c["idx"])))
    _equal(got, _jit(lambda x, i: jps.sharded_group(x, i, _jax_mesh()),
                     c["pts"], c["idx"]))


def _qg_unsharded(c, features):
    return ops.query_and_group(
        _t(c["xyz"]), _t(c["xyz"][:, :c["m"]]), c["r"], c["k"],
        features=features, mask=_t(c["mask"]), normalize_xyz=True,
        exact=True)


def test_sharded_query_and_group_matches_reference_and_unsharded(ranks):
    c = CASES["qg"]
    grouped, idx, gmask = _same_on_every_rank(ranks, "qg")
    want = _qg_unsharded(c, _t(c["feats"]))
    for got, w, name in zip((grouped, idx, gmask), want,
                            ("grouped", "idx", "group_mask")):
        _equal(got, w, name)
    j = _jit(lambda x, f, m: jps.sharded_query_and_group(
        x, x[:, :c["m"]], c["r"], c["k"], _jax_mesh(), features=f, mask=m,
        normalize_xyz=True), c["xyz"], c["feats"], c["mask"])
    _equal(idx, j[1])
    _equal(gmask, j[2])
    np.testing.assert_allclose(grouped, np.asarray(j[0]), atol=ATOL)


def test_sharded_grouping_gradient_equals_unsharded(ranks):
    """The features' gradient through the sharded grouping, on every rank,
    is the unsharded one: each rank's shard of it is summed back over the
    points group, and the replicated loss's gradient passes the group sum
    through."""
    c = CASES["qg"]
    feats = _t(c["feats"]).requires_grad_(True)
    grouped, _, gmask = _qg_unsharded(c, feats)
    (grouped.square() * gmask[..., None]).sum().backward()
    for r in ranks:
        _equal(r["qg_grad"], feats.grad)


def test_sharded_sa_stage_matches_reference_and_unsharded(ranks):
    c = CASES["sa"]
    new_xyz, grouped, inds, gmask, new_mask, pooled = _same_on_every_rank(
        ranks, "sa")
    xyz, feats, mask = _t(c["xyz"]), _t(c["feats"]), _t(c["mask"])
    inds_w = ops.furthest_point_sample(xyz, c["m"], mask=mask)
    new_xyz_w = ops.gather(xyz, inds_w)
    grouped_w, _, gmask_w = ops.query_and_group(
        xyz, new_xyz_w, c["r"], c["k"], features=feats, mask=mask,
        normalize_xyz=True, exact=True)
    new_mask_w = mask.gather(1, inds_w.long())
    gmask_w = gmask_w & new_mask_w[:, :, None]
    for got, want, name in ((inds, inds_w, "inds"),
                            (new_xyz, new_xyz_w, "new_xyz"),
                            (new_mask, new_mask_w, "new_mask"),
                            (gmask, gmask_w, "group_mask"),
                            (grouped, grouped_w, "grouped"),
                            (pooled, ops.masked_max(grouped_w, gmask_w, 2),
                             "pooled")):
        _equal(got, want, name)
    j = _jit(lambda x, f, m: jps.sharded_sa_stage(
        x, f, c["m"], c["r"], c["k"], _jax_mesh(), mask=m),
        c["xyz"], c["feats"], c["mask"])
    _equal(inds, j[2])
    _equal(gmask, j[3])
    _equal(new_mask, j[4])
    np.testing.assert_allclose(new_xyz, np.asarray(j[0]), atol=ATOL)
    np.testing.assert_allclose(grouped, np.asarray(j[1]), atol=ATOL)


# -------------------------------------------------------- hybrid DP x CP


def _rows_of(ranks, key):
    """The data ranks' rows, in data order: ranks 0 and 2 hold rows 0:B/2
    and B/2:B of the 2 x 2 mesh (each data slice's points ranks agree)."""
    for a, b in ((0, 1), (2, 3)):
        for x, y in zip(ranks[a][key], ranks[b][key]):
            _equal(x, y, key)
    return [np.concatenate([ranks[0][key][i], ranks[2][key][i]])
            for i in range(len(ranks[0][key]))]


def test_hybrid_sa_stage_matches_reference_and_unsharded(ranks):
    c = CASES["hybrid_sa"]
    new_xyz, grouped, inds, gmask, new_mask = _rows_of(ranks, "hybrid_sa")
    xyz, feats, mask = _t(c["xyz"]), _t(c["feats"]), _t(c["mask"])
    inds_w = ops.furthest_point_sample(xyz, c["m"], mask=mask)
    new_xyz_w = ops.gather(xyz, inds_w)
    grouped_w, _, gmask_w = ops.query_and_group(
        xyz, new_xyz_w, c["r"], c["k"], features=feats, mask=mask,
        normalize_xyz=True, exact=True)
    gmask_w = gmask_w & mask.gather(1, inds_w.long())[:, :, None]
    _equal(inds, inds_w)
    _equal(new_xyz, new_xyz_w)
    _equal(gmask, gmask_w)
    _equal(grouped, grouped_w)
    j = _jit(lambda x, f, m: jps.sharded_sa_stage(
        x, f, c["m"], c["r"], c["k"], jmesh((2, 4), ("data", "points")),
        mask=m, batch_axis="data"), c["xyz"], c["feats"], c["mask"])
    _equal(inds, j[2])
    _equal(gmask, j[3])
    np.testing.assert_allclose(grouped, np.asarray(j[1]), atol=ATOL)


def test_hybrid_knn_matches_reference_and_unsharded(ranks):
    c = CASES["hybrid_knn"]
    d2, idx = _rows_of(ranks, "hybrid_knn")
    want_d2, want_idx = ops.knn(_t(c["q"]), _t(c["s"]), c["k"],
                                support_mask=_t(c["mask"]))
    _equal(idx, want_idx)
    _equal(d2, want_d2)
    jd2, jidx = _jit(lambda q, x, m: jps.sharded_knn(
        q, x, c["k"], jmesh((2, 4), ("data", "points")), support_mask=m,
        batch_axis="data"), c["q"], c["s"], c["mask"])
    _equal(idx, jidx)
    np.testing.assert_allclose(d2, np.asarray(jd2), atol=ATOL)
    ref_d2, ref_idx = jops.knn(jnp.asarray(c["q"]), jnp.asarray(c["s"]),
                               c["k"], support_mask=jnp.asarray(c["mask"]))
    _equal(idx, ref_idx)


# ------------------------------------------------- collectives and mesh


def test_all_gather_is_exact_for_every_value(ranks):
    for r in ranks:
        g = r["gather"]
        want = np.array([[i * 1.5, np.inf, -np.inf, np.nan, 3.0e38]
                         for i in range(WORLD)], np.float32)
        np.testing.assert_array_equal(g["float"], want)  # NaN == NaN here
        _equal(g["int"], [[i, -7, 2 ** 30] for i in range(WORLD)])
        assert g["int"].dtype == np.int32
        _equal(g["bool"], [[i % 2 == 0] for i in range(WORLD)])
        assert g["bool"].dtype == bool
        _equal(g["broadcast"], [WORLD - 1.0])


def test_make_mesh_lays_ranks_out_row_major(ranks):
    for rank, r in enumerate(ranks):
        assert r["mesh"] == {"shape": {"points": WORLD}, "index": rank,
                             "group": (0, 1, 2, 3)}
        d, p = divmod(rank, 2)
        assert r["hybrid"] == {"shape": {"data": 2, "points": 2},
                               "index": (d, p), "data": (p, p + 2),
                               "points": (2 * d, 2 * d + 1)}


def test_shard_batch_keeps_contiguous_rows(ranks):
    """As NamedSharding lays out a batch (test_dp.py:113-121): the data
    index picks a contiguous block; ranks of one data slice agree."""
    a = np.arange(8 * 3).reshape(8, 3)
    for rank, r in enumerate(ranks):
        d = rank // 2
        _equal(r["rows"], a[4 * d:4 * d + 4])


def test_mesh_without_a_process_group_is_trivial():
    mesh = make_mesh((-1,), ("data",))
    assert mesh.shape == {"data": 1} and mesh.axis_index("data") == 0
    assert mesh.group("data").group is None
    batch = {"points": torch.zeros(4, 3)}
    assert shard_batch(batch, mesh)["points"] is batch["points"]
    for shape, axes, match in (((2,), ("data",), "holds 2 ranks"),
                               ((-1, -1), ("data", "points"), "one -1"),
                               ((1,), ("data", "points"), "length"),
                               ((1, 1), ("data", "data"), "repeat")):
        with pytest.raises(ValueError, match=match):
            make_mesh(shape, axes)
    with pytest.raises(ValueError, match="no axis 'points'"):
        shard_batch(batch, mesh, "points")


def test_config_parses_mesh_axes_and_cp_stages_as_reference():
    from tpu3dsad.config import apply_overrides as japply
    from tpu3dsad.config import Config as JConfig

    for ov in (["train.mesh_axes=data"],
               ["train.mesh_axes=(data,points)", "train.mesh_shape=(2,-1)"],
               ["model.cp_stages=2"]):
        got, want = apply_overrides(Config(), ov), japply(JConfig(), ov)
        assert got.train.mesh_axes == want.train.mesh_axes
        assert got.train.mesh_shape == want.train.mesh_shape
        assert got.model.cp_stages == want.model.cp_stages
    assert apply_overrides(Config(), ["train.mesh_axes=data"]
                           ).train.mesh_axes == ("data",)
    for cfg in (Config(), JConfig()):
        assert (cfg.model.cp_stages, cfg.train.mesh_axes) == (1, ("data",))
    for apply, base in ((apply_overrides, Config()), (japply, JConfig())):
        with pytest.raises(ValueError, match="expected a string"):
            apply(base, ["train.mesh_axes=(1,2)"])


def test_spawned_ranks_import_no_jax():
    """The module the ranks import by name loads neither JAX nor the JAX
    package (the spawn guard of the parallel tests)."""
    code = ("import sys\n"
            "sys.path.insert(0, 'tests')\n"
            "import test_torch_parallel_workers\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'flax', 'tpu3dsad')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
