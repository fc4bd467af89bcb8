"""The config-#4 (outdoor) pieces of the PyTorch port held against the JAX
package on the CPU: large single-cloud FPS, the sorted ball-query tier and
its dispatch, the config with its overrides and presets, the synthetic
outdoor writer, host preprocessing and the KITTI loader.

Everything compared here is integer or exact: FPS picks, ball-query idx
and cnt, parsed configs, written bytes, crop indices, vote targets and
masks, and the loaded batches key by key. The cluster FPS kernel (B2)
itself runs only on the card, where chip_smoke.py holds it against the
plain version; here the plain version is held against the reference's
XLA tier and numpy oracle, and the wrapper's dispatch is checked.
"""

import dataclasses
import importlib
import shutil
import typing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

import tpu3dsad.ops as jops
import tpu3dsad_torch.config as tconfig
from tpu3dsad import config as jconfig
from tpu3dsad.data import kitti as jkitti
from tpu3dsad.data import synthetic_outdoor as jso
from tpu3dsad.ops.oracle import ball_query_oracle, fps_oracle
from tpu3dsad.ops.xla import fps as jxfps
from tpu3dsad.utils import native
from tpu3dsad_torch import ops
from tpu3dsad_torch.data import host
from tpu3dsad_torch.data import kitti as tkitti
from tpu3dsad_torch.data import synthetic_indoor as tsi
from tpu3dsad_torch.data import synthetic_outdoor as tso
from tpu3dsad_torch.data.registry import get_dataset
from tpu3dsad_torch.ops import sorted as tsorted
from tpu3dsad_torch.ops.cuda import fps as cuda_fps

from test_torch_detector import PORT_ONLY, to_port

jpbq = importlib.import_module("tpu3dsad.ops.pallas.ball_query")


@pytest.fixture(autouse=True)
def _restore_grouping():
    """The port's fast-grouping state is process-wide; put it back."""
    fast, mode = ops.get_fast_grouping(), ops.get_fast_mode()
    yield
    ops.set_fast_grouping(fast)
    ops.set_fast_mode(mode)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


# ------------------------------------------------------ large-cloud FPS


@pytest.mark.parametrize("kind", ["n70000", "masked_tail"])
def test_large_single_cloud_fps_equals_xla_tier_and_oracle(kind):
    rng = np.random.default_rng(30)
    n = 70000 if kind == "n70000" else 66000
    xyz = rng.uniform(-40, 40, (1, n, 3)).astype(np.float32)
    mask = None
    if kind == "masked_tail":
        mask = np.ones((1, n), bool)
        mask[0, 60000:] = False
        mask[0, ::5] = False
        mask[0, 0] = True
    got = ops.furthest_point_sample(_t(xyz), 32, mask=_t(mask)).numpy()
    want = np.asarray(jxfps.furthest_point_sample(
        jnp.asarray(xyz), 32, mask=None if mask is None else jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[0], fps_oracle(xyz[0], 32, None if mask is None else mask[0]))


@pytest.mark.parametrize("B,N,kernel", [(1, 65537, "flat"), (1, 65536, "batched"),
                                        (2, 70000, "batched")])
def test_fps_wrapper_takes_the_cluster_kernel_for_one_large_cloud(
        monkeypatch, B, N, kernel):
    """B == 1 with N > 65536 goes to B2 (fps_flat), as the reference's
    fps.py:229-231 picks _fps_kernel_flat; everything else to B1."""
    taken = []
    monkeypatch.setattr(cuda_fps, "fps_flat", lambda *a: taken.append("flat"))
    monkeypatch.setattr(cuda_fps, "fps_batched",
                        lambda *a: taken.append("batched"))
    cuda_fps.furthest_point_sample(torch.zeros(B, N, 3), 16)
    assert taken == [kernel]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="one cloud"):
        cuda_fps.fps_flat(torch.zeros(2, 8, 3), 4)


# ------------------------------------------------------- sorted tier


def _clustered(rng, B=2, N=512, M=64):
    """Surface-like clustered cloud (tests/ops/test_pallas_ball_query.py)."""
    centers3 = rng.uniform(-1, 1, (B, 8, 3)).astype(np.float32)
    pick = rng.integers(0, 8, (B, N))
    xyz = centers3[np.arange(B)[:, None], pick] + rng.normal(
        0, 0.08, (B, N, 3)).astype(np.float32)
    return xyz, xyz[:, :M].copy()


def _sorted_case(kind):
    rng = np.random.default_rng(31)
    xyz, centers = _clustered(rng)
    mask, r, K = None, 0.25, 16
    if kind == "masked_junk":  # invalid points anywhere, at junk coordinates
        mask = rng.random(xyz.shape[:2]) < 0.75
        xyz[~mask] = rng.uniform(-50, 50, ((~mask).sum(), 3))
        mask[1, 400:] = False
    elif kind == "empty_and_saturated":  # far centers; dense balls
        centers[:, 40:] += 20.0
        r, K = 0.6, 8
    return xyz, centers, mask, r, K


@pytest.mark.parametrize("kind", ["clustered", "masked_junk",
                                  "empty_and_saturated"])
def test_sorted_ball_query_equals_reference(kind):
    xyz, centers, mask, r, K = _sorted_case(kind)
    idx, cnt = tsorted.sorted_ball_query(_t(xyz), _t(centers), r, K,
                                         mask=_t(mask))
    jidx, jcnt = jpbq.sorted_ball_query(
        jnp.asarray(xyz), jnp.asarray(centers), r, K,
        mask=None if mask is None else jnp.asarray(mask), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    # exact counts; the chosen set is the exact tier's where hits <= K
    for b in range(xyz.shape[0]):
        oi, oc = ball_query_oracle(xyz[b], centers[b], r, xyz.shape[1],
                                   None if mask is None else mask[b])
        np.testing.assert_array_equal(cnt[b].numpy(), np.minimum(oc, K))
        for m in np.nonzero(oc <= K)[0]:
            assert set(idx[b, m, :oc[m]].tolist()) == set(oi[m, :oc[m]].tolist())
    if kind == "empty_and_saturated":
        assert (cnt[:, 40:] == 0).all() and (idx[:, 40:] == 0).all()
        assert (cnt[:, :40] == K).any()


def test_sorted_views_are_the_reference_morton_order():
    """The Morton codes bit for bit: the sort permutation equals the one
    the reference's codes give."""
    xyz, centers, mask, _, _ = _sorted_case("masked_junk")
    xs, cs, perm, inv_c = tsorted.sorted_views(_t(xyz), _t(centers), _t(mask))
    valid = jnp.asarray(mask)
    x = jnp.where(valid[..., None], jnp.asarray(xyz), jnp.float32(1e9))
    mn = jnp.min(jnp.where(valid[..., None], x, 3e38), axis=1, keepdims=True)
    mx = jnp.max(jnp.where(valid[..., None], x, -3e38), axis=1, keepdims=True)
    inv_cell = 256.0 / jnp.maximum(mx - mn, 1e-6)
    codes = jnp.where(valid, jpbq._morton_codes(x, mn, inv_cell), 1 << 30)
    np.testing.assert_array_equal(
        perm.numpy(), np.argsort(np.asarray(codes), axis=1, kind="stable"))
    ccodes = np.asarray(jpbq._morton_codes(jnp.asarray(centers), mn, inv_cell))
    order = np.argsort(ccodes, axis=1, kind="stable")
    np.testing.assert_array_equal(np.take_along_axis(inv_c.numpy(), order, 1),
                                  np.broadcast_to(np.arange(64), (2, 64)))
    np.testing.assert_array_equal(xs.numpy(), np.take_along_axis(
        np.asarray(x), perm.numpy()[..., None], 1))


def test_fast_grouping_dispatch_at_and_below_the_gate(monkeypatch):
    """exact=False with mode 'sorted' runs the sorted tier where the
    reference's Pallas tier would (N >= the gate, K % 8 == 0, K <= N) and
    equals the reference's dispatch there; below the gate the port groups
    exactly (the reference falls to approx_max_k)."""
    xyz, centers, _, r, K = _sorted_case("clustered")
    x, c = _t(xyz), _t(centers)
    exact = ops.ball_query(x, c, r, K)
    sorted_ = tsorted.sorted_ball_query(x, c, r, K)
    assert not torch.equal(exact[0], sorted_[0])  # slot orders differ
    ops.set_fast_mode("sorted")
    monkeypatch.setattr(tsorted, "SORTED_MIN_N", 512)  # N = 512: at the gate
    monkeypatch.setattr(jpbq, "_SORTED_MIN_N", 512)
    old_mode = jops.get_fast_mode()
    jops.set_fast_mode("sorted")
    try:
        jat = jpbq.ball_query(jnp.asarray(xyz), jnp.asarray(centers), r, K,
                              exact=False, interpret=True)
    finally:
        jops.set_fast_mode(old_mode)
    at = ops.ball_query(x, c, r, K, exact=False)
    for got, want, ref in zip(at, sorted_, jat):
        assert torch.equal(got, want)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ops.set_fast_grouping(True)  # exact=None follows the global switch
    assert all(torch.equal(a, b) for a, b in zip(ops.ball_query(x, c, r, K),
                                                 sorted_))
    assert all(torch.equal(a, b) for a, b in zip(
        ops.ball_query(x, c, r, K, exact=True), exact))
    grouped, gidx, _ = ops.query_and_group(x, c, r, K)
    assert torch.equal(gidx, sorted_[0])
    for n_gate, k in ((513, K), (512, 12)):  # below the gate; K % 8 != 0
        monkeypatch.setattr(tsorted, "SORTED_MIN_N", n_gate)
        got = ops.ball_query(x, c, r, k, exact=False)
        want = ops.ball_query(x, c, r, k, exact=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tsorted.launches == 0  # the CPU ran the plain exact tier


def test_approx_fast_mode_raises():
    xyz, centers, _, r, K = _sorted_case("clustered")
    ops.set_fast_mode("approx")
    with pytest.raises(NotImplementedError, match="approx_max_k"):
        ops.ball_query(_t(xyz), _t(centers), r, K, exact=False)
    ops.set_fast_grouping(True)
    with pytest.raises(NotImplementedError, match="TPU"):
        ops.query_and_group(_t(xyz), _t(centers), r, K)
    with pytest.raises(ValueError):
        ops.set_fast_mode("approx_max_k")


# ------------------------------------------------------------- config


def _sections(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if dataclasses.is_dataclass(getattr(cfg, f.name))}


def test_config_defaults_equal_reference_but_fast_grouping():
    """Every field of the port's config has the reference's default, but
    one: ops_fast_grouping is False in the port. The reference's default
    fast tier is lax.approx_max_k, which exists only on the TPU; the port
    groups exactly unless asked for the sorted tier."""
    port, ref = tconfig.Config(), jconfig.Config()
    for name, section in _sections(port).items():
        for f in dataclasses.fields(section):
            if f.name in PORT_ONLY:  # 3DSSD's, the port's alone
                continue
            assert getattr(section, f.name) == getattr(getattr(ref, name),
                                                       f.name), (name, f.name)
    for f in dataclasses.fields(port):
        if f.name in _sections(port):
            continue
        if f.name == "ops_fast_grouping":
            assert (port.ops_fast_grouping, ref.ops_fast_grouping) == (
                False, True)
        else:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name


OVERRIDES = [
    ["preset=outdoor"],
    ["preset=outdoor", "train.lr=5e-4", "data.root=/data/kitti",
     "data.device_preproc=true"],
    ["model.sa_radii=(0.8,1.6,3.2,6.4)",
     "model.sa_channels=((16,16),(16,32),(16,32),(16,32))",
     "model.fp_channels=((32, 32), (32, 32))", "train.lr_decay_steps=(80)"],
    ["preset=sunrgbd", "model.num_classes=4", "eval.ap_iou_threshs=(0.5,)",
     "eval.per_class_proposal=false", "eval.conf_thresh=0"],
    ["preset=scannet", "data.augment=0", "data.compact_votes=yes",
     "train.mesh_shape=(-1,)", "ops_fast_mode=sorted",
     "ops_fast_grouping=on", "train.lr_decay_steps=()"],
    ["data.vote_candidates=1", "train.seed=3",
     "model.proposal_mode=lineage"],
    ["preset=classifier", "model.classifier_msg=true", "model.dropout=0.2",
     "data.name=modelnet", "data.root=/data/modelnet_npy"],
]


@pytest.mark.parametrize("argv", OVERRIDES, ids=range(len(OVERRIDES)))
def test_parse_cli_equals_reference(argv):
    """Every field the port has, parsed as the reference parses it; only
    ops_fast_grouping keeps the port's default unless it is given."""
    port, ref = tconfig.parse_cli(argv), jconfig.parse_cli(argv)
    explicit = any(a.startswith("ops_fast_grouping=") for a in argv)
    assert port == dataclasses.replace(
        to_port(ref), ops_fast_mode=ref.ops_fast_mode,
        ops_fast_grouping=ref.ops_fast_grouping if explicit else False)
    assert tconfig.describe(port).splitlines()[0].startswith("model: ")


@pytest.mark.parametrize("bad", ["model.nope=1", "train.lr", "preset=mars",
                                 "model.num_classes=three",
                                 "model.sa_radii=(0.8,'x')"])
def test_bad_overrides_raise_like_reference(bad):
    """Both parsers refuse the same strings."""
    for mod in (jconfig, tconfig):
        with pytest.raises(ValueError):
            if "=" in bad:
                mod.parse_cli([bad])
            else:  # parse_cli skips words without '='
                mod.apply_overrides(mod.Config(), [bad])


def test_nested_tuple_annotations_resolve():
    hints = typing.get_type_hints(tconfig.ModelConfig)
    assert tconfig._coerce("((1,2),(3,))", hints["sa_channels"]) == (
        (1, 2), (3,))
    assert tconfig._coerce("kitti", typing.get_type_hints(
        tconfig.DataConfig)["name"]) == "kitti"


# ------------------------------------------- writer, preprocessing, loader


def test_write_dataset_is_byte_identical(tmp_path):
    for mod, sub in ((jso, "j"), (tso, "t")):
        mod.write_dataset(str(tmp_path / sub), scenes=2, val_scenes=1,
                          num_points=40000, seed=5)
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*.npy"))
    assert len(files) == 6
    assert files == sorted(p.relative_to(tmp_path / "t")
                           for p in (tmp_path / "t").rglob("*.npy"))
    for f in files:
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f


def _face_points(boxes, per_face=40, seed=0):
    """Points exactly on every face of every box (local coordinates
    +-half extent, rotated and shifted in float32): the cases where
    rounding decides membership."""
    rng = np.random.default_rng(seed)
    out = []
    for b in boxes.astype(np.float32):
        half = b[3:6] * np.float32(0.5)
        local = rng.uniform(-1, 1, (6 * per_face, 3)).astype(np.float32) * half
        for f in range(6):
            local[f * per_face:(f + 1) * per_face, f // 2] = \
                half[f // 2] * (1 if f % 2 else -1)
        c, s = np.float32(np.cos(b[6])), np.float32(np.sin(b[6]))
        x = c * local[:, 0] - s * local[:, 1] + b[0]
        y = s * local[:, 0] + c * local[:, 1] + b[1]
        out.append(np.stack([x, y, local[:, 2] + b[2]], -1))
    return np.concatenate(out).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_range_crop_and_vote_targets_equal_native(seed):
    assert native.available()  # the reference's C++ arithmetic
    pc, boxes = jso.outdoor_scene(np.random.default_rng(seed), 40000)
    lo, hi = jkitti.RANGE_MIN, jkitti.RANGE_MAX
    keep = host.range_crop(pc, lo, hi)
    np.testing.assert_array_equal(keep, native.range_crop(pc, lo, hi))
    np.testing.assert_array_equal(tkitti.range_crop(pc), keep)
    pts = np.concatenate([pc[keep, :3], _face_points(boxes, seed=seed)])
    votes, vmask = host.vote_targets(pts, boxes)
    nvotes, nvmask = native.vote_targets(pts, boxes)
    differ = np.nonzero(vmask != nvmask)[0]
    assert differ.size == 0, (
        f"membership differs at points {differ[:5].tolist()}: "
        f"{pts[differ[:5]].tolist()}")
    np.testing.assert_array_equal(votes, nvotes)
    assert 0 < vmask.sum() < len(pts)


def _loader_cfg(root, device_preproc):
    return jconfig.apply_overrides(jconfig.Config(), [
        "data.name=kitti", f"data.root={root}",
        "data.num_points=1024", "data.max_boxes=16", "data.augment=false",
        f"data.device_preproc={device_preproc}"])


@pytest.mark.parametrize("device_preproc", [False, True])
def test_kitti_val_batches_equal_reference(tmp_path, monkeypatch,
                                           device_preproc):
    """The same scenes in two copies of one directory (each loader writes
    its own FPS caches): batches equal key by key, cache files byte-equal,
    and a second pass reads the caches without any FPS."""
    tso.write_dataset(str(tmp_path / "j"), scenes=1, val_scenes=3,
                      num_points=40000, seed=2)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    ref = _loader_cfg(tmp_path / "j", device_preproc)
    jds = jkitti.KittiDetectionDataset(ref)
    tds = get_dataset(to_port(dataclasses.replace(
        ref, data=dataclasses.replace(ref.data, root=str(tmp_path / "t")))),
        device="cpu")
    want = list(jds.val_batches(np.random.default_rng(0), 2))
    got = list(tds.val_batches(np.random.default_rng(0), 2))
    assert len(got) == len(want) == 2
    assert [b["scene_mask"].tolist() for b in got] == [[True, True],
                                                       [True, False]]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    caches = sorted(p.name for p in (tmp_path / "j" / "val").glob(
        "*_fpscache_1024.npy"))
    assert len(caches) == 3
    for name in caches:
        assert (tmp_path / "j" / "val" / name).read_bytes() == \
            (tmp_path / "t" / "val" / name).read_bytes(), name
    calls = []
    fps = ops.furthest_point_sample
    monkeypatch.setattr(ops, "furthest_point_sample",
                        lambda *a, **k: calls.append(1) or fps(*a, **k))
    again = list(tds.val_batches(np.random.default_rng(0), 2))
    assert calls == []
    for g, w in zip(again, got):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_kitti_unported_paths_raise(tmp_path):
    """Host augmentation and compact votes, which this test once showed
    refused (hence its name), now load; augmentation moves points and boxes,
    and compact votes carry int8 owners in place of the targets."""
    tso.write_dataset(str(tmp_path), scenes=1, val_scenes=1,
                      num_points=40000, seed=2)
    cfg = tconfig.parse_cli(["preset=outdoor", f"data.root={tmp_path}",
                             "data.num_points=1024"])
    ds = get_dataset(cfg, device="cpu")
    aug = ds.train_batch(np.random.default_rng(0), 2)  # data.augment=true
    compact = get_dataset(tconfig.apply_overrides(
        cfg, ["data.compact_votes=true"]), device="cpu").train_batch(
            np.random.default_rng(0), 2)
    assert compact["vote_owner"].dtype == np.int8
    assert "vote_targets" not in compact
    np.testing.assert_array_equal(compact["points"], aug["points"])
    assert (compact["vote_owner"] >= 0).sum() == aug["vote_mask"].sum()
    ok = get_dataset(tconfig.apply_overrides(cfg, ["data.augment=false"]),
                     device="cpu").train_batch(np.random.default_rng(0), 2)
    assert ok["points"].shape == aug["points"].shape == (2, 1024, 3)
    assert ok["vote_targets"].shape == (2, 1024, 3, 3)
    assert not np.array_equal(ok["points"], aug["points"])
    assert not np.array_equal(ok["gt_headings"], aug["gt_headings"])
    # preset=scannet, refused until ROADMAP A7.2, loads ScanNet files
    with pytest.raises(FileNotFoundError, match="data.root"):
        get_dataset(tconfig.parse_cli(["preset=scannet"]))
    indoor = str(tmp_path / "indoor")
    tsi.write_dataset(indoor, scenes=1, val_scenes=0, num_points=2000)
    scannet = get_dataset(tconfig.parse_cli(
        ["preset=scannet", f"data.root={indoor}", "data.num_points=1024"]))
    assert scannet.train_batch(np.random.default_rng(0), 2)[
        "vote_targets"].shape == (2, 1024, 3, 3)
