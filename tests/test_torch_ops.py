"""Point ops of the PyTorch port (tpu3dsad_torch.ops) held against the JAX
package on the CPU.

FPS and ball query must equal, integer for integer, the numpy oracles, the
exact XLA tier and the Pallas kernels (in interpret mode). The float ops
agree with the XLA tier at rtol 1e-5: same fp32 formulas, other summation
orders. On the CPU the ops take their plain versions; the CUDA kernels are
checked against those on the card by chip_smoke.py.
"""

import importlib
import subprocess
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpu3dsad.ops import xla as jx
from tpu3dsad.ops.masked import masked_max as jx_masked_max
from tpu3dsad.ops.oracle import ball_query_oracle, fps_oracle
from tpu3dsad.ops.pallas.ball_query import ball_query as pallas_bq
from tpu3dsad.ops.pallas.fps import furthest_point_sample as pallas_fps
from tpu3dsad_torch import ops
from tpu3dsad_torch.ops.cuda import ball_query as cuda_bq
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda import fps as cuda_fps

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _fps_case(kind):
    rng = np.random.default_rng(10)
    B, N, M = 3, 300, 48
    xyz = rng.uniform(-2, 2, (B, N, 3)).astype(np.float32)
    mask = None
    if kind == "masked":
        mask = rng.random((B, N)) < 0.7
        mask[:, 0] = True
    elif kind == "ties":  # integer grid: many exactly equal distances
        xyz = rng.integers(-3, 4, (B, N, 3)).astype(np.float32)
    elif kind == "all_pad_tail":  # padded tails, one scene all padding
        xyz[:, 200:] = 100.0
        mask = np.ones((B, N), bool)
        mask[:, 200:] = False
        mask[2] = False
    return xyz, mask, M


@pytest.mark.parametrize("kind", ["random", "masked", "ties", "all_pad_tail"])
def test_fps_equals_oracle_xla_pallas(kind):
    xyz, mask, M = _fps_case(kind)
    got = ops.furthest_point_sample(_t(xyz), M, mask=_t(mask)).numpy()
    assert got.dtype == np.int32 and got.shape == (xyz.shape[0], M)
    for b in range(xyz.shape[0]):
        want = fps_oracle(xyz[b], M, None if mask is None else mask[b])
        np.testing.assert_array_equal(got[b], want, err_msg=f"oracle b={b}")
    np.testing.assert_array_equal(
        got, np.asarray(jx.furthest_point_sample(_j(xyz), M, mask=_j(mask))))
    with pltpu.force_tpu_interpret_mode():
        np.testing.assert_array_equal(
            got, np.asarray(pallas_fps(_j(xyz), M, mask=_j(mask))))


def _bq_case(kind):
    rng = np.random.default_rng(20)
    B, N, M = 2, 256, 32
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    centers = xyz[:, :M] + rng.normal(0, 0.05, (B, M, 3)).astype(np.float32)
    mask, radius, K = None, 0.4, 16
    if kind == "masked":
        mask = np.ones((B, N), bool)
        mask[:, 190:] = False
        mask[1, ::3] = False
    elif kind == "empty_balls":  # half the centers far from every point
        centers[:, M // 2:] += 10.0
        radius = 0.2
    elif kind == "k8_saturated":
        radius, K = 0.9, 8
    elif kind == "nsample_gt_n":
        xyz = xyz[:, :12]
        radius, K = 0.8, 16
    return xyz, centers, mask, radius, K


@pytest.mark.parametrize(
    "kind", ["random", "masked", "empty_balls", "k8_saturated", "nsample_gt_n"])
def test_ball_query_equals_oracle_xla_pallas(kind):
    xyz, centers, mask, r, K = _bq_case(kind)
    idx, cnt = ops.ball_query(_t(xyz), _t(centers), r, K, mask=_t(mask))
    idx, cnt = idx.numpy(), cnt.numpy()
    assert idx.dtype == np.int32 and cnt.dtype == np.int32
    for b in range(xyz.shape[0]):
        oi, oc = ball_query_oracle(xyz[b], centers[b], r, K,
                                   None if mask is None else mask[b])
        np.testing.assert_array_equal(idx[b], oi, err_msg=f"oracle b={b}")
        np.testing.assert_array_equal(cnt[b], oc, err_msg=f"oracle b={b}")
    xi, xc = jx.ball_query(_j(xyz), _j(centers), r, K, mask=_j(mask),
                           exact=True)
    np.testing.assert_array_equal(idx, np.asarray(xi))
    np.testing.assert_array_equal(cnt, np.asarray(xc))
    with pltpu.force_tpu_interpret_mode():
        pi, pc = pallas_bq(_j(xyz), _j(centers), r, K, mask=_j(mask))
    np.testing.assert_array_equal(idx, np.asarray(pi))
    np.testing.assert_array_equal(cnt, np.asarray(pc))
    if kind == "empty_balls":
        assert (cnt[:, 16:] == 0).all() and (idx[:, 16:] == 0).all()


def test_ball_query_center_chunks(monkeypatch):
    """Centers run in serial chunks above the slab limit; the result does
    not depend on the chunking."""
    bq_mod = importlib.import_module("tpu3dsad_torch.ops.plain.ball_query")
    xyz, centers, mask, r, K = _bq_case("masked")
    whole = bq_mod.ball_query(_t(xyz), _t(centers), r, K, mask=_t(mask))
    monkeypatch.setattr(bq_mod, "_SLAB_LIMIT", 2 * 256 * 5)  # 5 centers
    chunked = bq_mod.ball_query(_t(xyz), _t(centers), r, K, mask=_t(mask))
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("features,use_xyz,normalize",
                         [(True, True, True), (True, False, False),
                          (False, True, False)])
def test_query_and_group_matches_xla(features, use_xyz, normalize):
    xyz, centers, mask, r, K = _bq_case("masked")
    feats = np.random.default_rng(1).normal(size=xyz.shape[:2] + (5,))
    feats = feats.astype(np.float32) if features else None
    g, i, m = ops.query_and_group(_t(xyz), _t(centers), r, K,
                                  features=_t(feats), mask=_t(mask),
                                  use_xyz=use_xyz, normalize_xyz=normalize)
    jg, ji, jm = jx.query_and_group(_j(xyz), _j(centers), r, K,
                                    features=_j(feats), mask=_j(mask),
                                    use_xyz=use_xyz, normalize_xyz=normalize,
                                    exact=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL, atol=ATOL)


def test_group_and_gather_match_xla():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(2, 50, 7)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 9, 4)).astype(np.int32)
    np.testing.assert_array_equal(ops.group(_t(pts), _t(idx)).numpy(),
                                  np.asarray(jx.group(_j(pts), _j(idx))))
    np.testing.assert_array_equal(
        ops.gather(_t(pts), _t(idx[:, :, 0])).numpy(),
        np.asarray(jx.gather(_j(pts), _j(idx[:, :, 0]))))


@pytest.mark.parametrize("masked", [False, True])
def test_three_nn_and_interpolate_match_xla(masked):
    rng = np.random.default_rng(3)
    q = rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
    s = rng.uniform(-1, 1, (2, 16, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 16, 6)).astype(np.float32)
    mask = (rng.random((2, 16)) < 0.6) if masked else None
    d2, idx = ops.three_nn(_t(q), _t(s), support_mask=_t(mask))
    jd2, jidx = jx.three_nn(_j(q), _j(s), support_mask=_j(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=RTOL,
                               atol=ATOL)
    w = ops.interp_weights(d2)
    jw = jx.interp_weights(jd2)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=RTOL,
                               atol=ATOL)
    out = ops.three_interpolate(_t(feats), idx, w)
    jout = jx.three_interpolate(_j(feats), jidx, jw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)


def test_masked_max_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    mask = rng.random((2, 5, 6)) < 0.5
    mask[0, 0] = False  # an all-invalid group pools to 0
    got = ops.masked_max(_t(x), _t(mask), 2).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jx_masked_max(_j(x), _j(mask), 2)))
    assert (got[0, 0] == 0).all()


def test_cpu_tensors_take_plain_versions_without_launching():
    xyz, centers, mask, r, K = _bq_case("random")
    before = (cuda_fps.launches, cuda_bq.launches)
    ops.furthest_point_sample(_t(xyz), 8)
    ops.ball_query(_t(xyz), _t(centers), r, K)
    assert (cuda_fps.launches, cuda_bq.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    xyz, centers, mask, r, K = _bq_case("random")
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_fps.furthest_point_sample(_t(xyz), 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_bq.ball_query(_t(xyz), _t(centers), r, K)


def test_impl_selection():
    assert ops._impl == "auto"
    with ops.use_impl("plain"):
        assert ops._impl == "plain"
    assert ops._impl == "auto"
    with pytest.raises(ValueError):
        with ops.use_impl("pallas"):
            pass
    assert ops._impl == "auto"


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "LIB_PATH", tmp_path / "build" / "lib.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library()
    assert not (tmp_path / "build").exists()


def test_build_key_follows_sources(tmp_path):
    a = tmp_path / "a.cu"
    a.write_text("// one")
    first = build._digest([a])
    a.write_text("// two")
    assert build._digest([a]) != first
    assert {p.name for p in build._sources()} >= {"fps.cu", "ball_query.cu",
                                                  "scatter.cu"}


def test_cached_build_is_reported(monkeypatch, tmp_path):
    """A process that finds the library built from the same sources loads
    it without nvcc and says so; a changed source rebuilds it."""
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "csrc" / "k.cu"
    src.write_text("// one")
    runs = []

    def fake_nvcc_run(cmd, **_):
        runs.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as lib:
            lib.write(b"so")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info: 30 registers",
                                           "")

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "LIB_PATH", tmp_path / "build" / "lib.so")
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_nvcc_run)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: FakeLib())
    lines = []
    for source in ("// one", "// one", "// two"):
        src.write_text(source)
        monkeypatch.setattr(build, "_lib", None)  # as in a new process
        lines.append(build.describe())
    links = [cmd for cmd in runs if "-shared" in cmd]
    assert len(links) == 2 and len(runs) == 4  # one compile + one link each
    assert lines[0].startswith("build: nvcc ") and " -> " in lines[0]
    assert lines[1] == f"build: cached (source hash matches) -> " \
                       f"{tmp_path / 'build' / 'lib.so'}"
    assert lines[2].startswith("build: nvcc ")


@pytest.mark.parametrize("call", [
    lambda x, c, m: ops.furthest_point_sample(x[..., :2], 4),
    lambda x, c, m: ops.furthest_point_sample(x, 0),
    lambda x, c, m: ops.furthest_point_sample(x, x.shape[1] + 1),
    lambda x, c, m: ops.furthest_point_sample(x, 4, mask=m[:, 1:]),
    lambda x, c, m: ops.ball_query(x, c[..., :2], 0.5, 8),
    lambda x, c, m: ops.ball_query(x, c[:1], 0.5, 8),
    lambda x, c, m: ops.ball_query(x, c, 0.5, 0),
    lambda x, c, m: ops.ball_query(x, c, 0.5, 8, mask=m[:1]),
], ids=["fps_xyz_2d", "fps_npoint_0", "fps_npoint_gt_n", "fps_mask_shape",
        "bq_centers_2d", "bq_batch", "bq_nsample_0", "bq_mask_shape"])
def test_bad_arguments_raise(call):
    xyz, centers, mask, _, _ = _bq_case("masked")
    with pytest.raises(ValueError):
        call(_t(xyz), _t(centers), _t(mask))
