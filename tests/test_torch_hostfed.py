"""The host-fed training path of the PyTorch port (config #3 from files on
disk) held against the JAX package on the CPU: the ScanNet and SUN RGB-D
scene writers and loaders, the host synthetic dataset, augment_scene, the
host pipeline and the Batcher, packed splits and device_prefetch,
validate, one train step from a host-fed batch with colour, and
run_detector with evaluation inside training and the best-mAP snapshot.

Tolerances, with their reasons:

  * every numpy output (files, batches, packs, augmentation, pipeline
    functions, Batcher streams, validate's reports): bitwise equal, the
    same numpy code drawing from the same np.random.default_rng seeds;
  * the train step from bridged weights: loss rtol 1e-5 and the
    per-parameter gradient bar of tests/test_torch_train.py (GRAD_RTOL of
    the tensor's own max |grad| + GRAD_ATOL of the model's largest), for
    the reasons given there;
  * the best-mAP snapshot restored and evaluated again: the logged mAP
    exactly (both rounded to 4 places, the same weights and batches).
"""

import dataclasses
import inspect
import json
import os
import shutil
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

import tpu3dsad_torch.config as tconfig
from tpu3dsad import config as jconfig
from tpu3dsad import losses as jlosses
from tpu3dsad.data import augment as jaug
from tpu3dsad.data import packed as jpacked
from tpu3dsad.data import pipeline as jpipe
from tpu3dsad.data import synthetic as jsyn
from tpu3dsad.data import synthetic_indoor as jsi
from tpu3dsad.data import synthetic_sunrgbd as jss
from tpu3dsad.data import validate as jval
from tpu3dsad.data.registry import get_dataset as jget
from tpu3dsad.models.detector import SizeAdaptiveDetector as JDetector
from tpu3dsad_torch import train_detector as tdet
from tpu3dsad_torch import train_lib
from tpu3dsad_torch.data import augment as taug
from tpu3dsad_torch.data import packed as tpacked
from tpu3dsad_torch.data import pipeline as tpipe
from tpu3dsad_torch.data import synthetic as tsyn
from tpu3dsad_torch.data import synthetic_indoor as tsi
from tpu3dsad_torch.data import synthetic_outdoor as tso
from tpu3dsad_torch.data import synthetic_sunrgbd as tss
from tpu3dsad_torch.data import validate as tval
from tpu3dsad_torch.data.registry import get_dataset as tget
from tpu3dsad_torch.data.scannet import SCANNET_MEAN_SIZES
from tpu3dsad_torch.eval.parse import parse_predictions
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.parallel import make_mesh
from tpu3dsad_torch.utils.bridge import load_flax_variables, state_dict_from_flax

from test_torch_detector import SMALL, to_port
from test_torch_train import GRAD_ATOL, GRAD_RTOL

# SMALL's widths as overrides, for configs parsed the way the CLI does
TINY_MODEL = [
    "model.sa_npoints=(64,32,16,8)", "model.sa_nsamples=(16,8,8,8)",
    "model.sa_channels=((16,16),(16,32),(16,32),(16,32))",
    "model.fp_channels=((32,32),(32,32))", "model.seed_feat_dim=32",
    "model.num_proposals=16", "model.cluster_nsample=8",
]
POINTS, RAW_POINTS = 2048, 3000


def _cfgs(args):
    """(the port's Config, the reference's) of the same overrides."""
    return (tconfig.apply_overrides(tconfig.Config(), args),
            jconfig.apply_overrides(jconfig.Config(), args))


def _equal(got: dict, want: dict, msg=""):
    """Bitwise equal numpy dicts: keys, dtypes, shapes and bytes."""
    assert set(got) == set(want), msg
    for k, w in want.items():
        g = np.asarray(got[k])
        w = np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (msg, k)
        assert g.tobytes() == w.tobytes(), (msg, k)


def _same_files(a, b):
    names = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    return names


def _within(seconds: float, fn):
    """fn() on a thread; fails unless it returns within `seconds`."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # raised again on the test's thread
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(seconds)
    assert not th.is_alive(), f"still running after {seconds} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


# ------------------------------------------------------------- writers


WRITERS = {"scannet": (tsi, jsi), "sunrgbd": (tss, jss)}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{family: (the port writer's root, the reference writer's)}: 4 train
    and 3 val scenes of 3000 points from seed 0; 'sunrgbd_novotes' is the
    port's SUN RGB-D root without its votes files (votes computed from the
    boxes)."""
    base = tmp_path_factory.mktemp("hostfed")
    out = {}
    for family, writers in WRITERS.items():
        out[family] = tuple(
            w.write_dataset(str(base / f"{family}_{side}"), scenes=4,
                            val_scenes=3, num_points=RAW_POINTS, seed=0)
            for side, w in zip(("port", "ref"), writers))
    novotes = base / "sunrgbd_novotes"
    shutil.copytree(out["sunrgbd"][0], novotes)
    for f in novotes.rglob("*_votes.npy"):
        f.unlink()
    out["sunrgbd_novotes"] = (str(novotes), str(novotes))
    return out


@pytest.mark.parametrize("family", list(WRITERS))
def test_writers_are_byte_identical(roots, family, tmp_path, capsys):
    port, ref = roots[family]
    names = _same_files(Path(port), Path(ref))
    assert len(names) == (4 if family == "scannet" else 3) * 7
    # the CLI, on other arguments
    tw, jw = WRITERS[family]
    for side, w in (("port", tw), ("ref", jw)):
        w.main([f"out={tmp_path / side}", "scenes=1", "val_scenes=1",
                "points=500", "seed=3"])
    assert capsys.readouterr().out.count("wrote") == 2
    _same_files(tmp_path / "port", tmp_path / "ref")


# ------------------------------------------------------------- loaders


LOADER_CASES = [(c, v, k, a) for c in (False, True) for v in (1, 3)
                for k in (False, True) for a in (False, True)]


@pytest.mark.parametrize("use_color,V,compact,augment", LOADER_CASES,
                         ids=[f"color{int(c)}-V{v}-compact{int(k)}-aug{int(a)}"
                              for c, v, k, a in LOADER_CASES])
@pytest.mark.parametrize("family", ["scannet", "sunrgbd", "sunrgbd_novotes"])
def test_loader_batches_equal_reference(roots, family, use_color, V, compact,
                                        augment):
    """train_batch (two seeds) and the whole val sweep, each side reading
    its own writer's files. A SUN RGB-D scene with a votes file refuses
    compact votes in both packages."""
    name = family.split("_")[0]
    common = [f"data.name={name}", f"data.num_points={POINTS}",
              "data.max_boxes=16", f"data.use_color={use_color}",
              f"data.vote_candidates={V}", f"data.compact_votes={compact}",
              f"data.augment={augment}"]
    port_root, ref_root = roots[family]
    tds = tget(_cfgs(common + [f"data.root={port_root}"])[0], device="cpu")
    jds = jget(_cfgs(common + [f"data.root={ref_root}"])[1])
    assert (tds.num_classes, tds.class_names) == (jds.num_classes,
                                                  jds.class_names)
    assert tds.steps_per_epoch(3) == jds.steps_per_epoch(3) == 1
    if family == "sunrgbd" and compact:
        for ds in (tds, jds):
            with pytest.raises(ValueError, match="compact_votes"):
                ds.train_batch(np.random.default_rng(0), 2)
        return
    for seed in (0, 1):
        _equal(tds.train_batch(np.random.default_rng(seed), 3),
               jds.train_batch(np.random.default_rng(seed), 3), seed)
    tv = list(tds.val_batches(np.random.default_rng(5), 2))
    jv = list(jds.val_batches(np.random.default_rng(5), 2))
    assert len(tv) == len(jv) == 2
    for t, j in zip(tv, jv):
        _equal(t, j, "val")
    assert list(tv[1]["scene_mask"]) == [True, False]


@pytest.mark.parametrize("V", [1, 3])
def test_synthetic_host_dataset_equals_reference(V):
    tcfg, jcfg = _cfgs(["data.name=synthetic", "data.num_points=512",
                        "data.max_boxes=8", f"data.vote_candidates={V}",
                        "model.num_classes=6"])
    tds, jds = tget(tcfg, device="cpu"), jget(jcfg)
    np.testing.assert_array_equal(tds.mean_sizes, jds.mean_sizes)
    assert tds.class_names == jds.class_names
    _equal(tds.train_batch(np.random.default_rng(3), 2),
           jds.train_batch(np.random.default_rng(3), 2))
    tv = list(tds.val_batches(np.random.default_rng(0), 2))
    jv = list(jds.val_batches(np.random.default_rng(1), 2))  # fixed val set
    assert len(tv) == len(jv) == 4
    for t, j in zip(tv, jv):
        _equal(t, j)
    _equal(tsyn.classification_batch(np.random.default_rng(4), 3, 100),
           jsyn.classification_batch(np.random.default_rng(4), 3, 100))
    for kind in tsyn.SHAPE_NAMES:
        _equal({"p": tsyn.make_shape(kind, 50, np.random.default_rng(2))},
               {"p": jsyn.make_shape(kind, 50, np.random.default_rng(2))})


def test_registry_refuses_modelnet_and_unknown_names():
    """modelnet is registered (tests/test_torch_classifier.py loads it):
    like the file-backed detection sets, it refuses a missing root."""
    with pytest.raises(ValueError, match="unknown dataset"):
        tget(_cfgs(["data.name=nope"])[0], device="cpu")
    for name in ("scannet", "sunrgbd", "packed", "modelnet"):
        with pytest.raises(FileNotFoundError):
            tget(_cfgs([f"data.name={name}", "data.root=/nonexistent"])[0],
                 device="cpu")


# ------------------------------------------------ augmentation, pipeline


CUSTOM = ["data.aug_preset=custom", "data.aug_flip_y=false",
          "data.aug_rot_range=0.3", "data.aug_scale_min=0.9",
          "data.aug_scale_max=1.2"]


@pytest.mark.parametrize("preset", ["scannet", "sunrgbd", "kitti", "custom",
                                    "auto"])
def test_augment_scene_and_recipes_equal_reference(preset):
    args = CUSTOM if preset == "custom" else [f"data.aug_preset={preset}"]
    tcfg, jcfg = _cfgs(args)
    recipe = taug.resolve_aug(tcfg.data, "sunrgbd")
    assert recipe == jaug.resolve_aug(jcfg.data, "sunrgbd")
    assert taug.AUG_PRESETS == jaug.AUG_PRESETS
    rng = np.random.default_rng(9)
    points = rng.uniform(-3, 3, (300, 6)).astype(np.float32)
    centers = rng.uniform(-2, 2, (5, 3)).astype(np.float32)
    headings = rng.uniform(-np.pi, np.pi, 5).astype(np.float32)
    sizes = rng.uniform(0.3, 2, (5, 3)).astype(np.float32)
    for seed in range(6):  # flips on and off
        got = taug.augment_scene(np.random.default_rng(seed), points,
                                 centers, headings, sizes, **recipe)
        want = jaug.augment_scene(np.random.default_rng(seed), points,
                                  centers, headings, sizes, **recipe)
        _equal(dict(enumerate(got)), dict(enumerate(want)), seed)
    _equal({"r": taug.rot_z(0.7)}, {"r": jaug.rot_z(0.7)})
    bad_t, bad_j = _cfgs(["data.aug_preset=scanet"])
    for fn, cfg in ((taug.resolve_aug, bad_t), (jaug.resolve_aug, bad_j)):
        with pytest.raises(ValueError, match="aug_preset"):
            fn(cfg.data, "scannet")


def test_pipeline_functions_equal_reference():
    rng = np.random.default_rng(21)
    pts = rng.standard_normal((50, 4)).astype(np.float32)
    for budget, seed in ((30, 1), (30, None), (80, 2)):
        got = tpipe.pad_points(pts, budget, None if seed is None
                               else np.random.default_rng(seed))
        want = jpipe.pad_points(pts, budget, None if seed is None
                                else np.random.default_rng(seed))
        _equal(dict(enumerate(got)), dict(enumerate(want)), budget)
    for g in (3, 9):
        _equal(dict(enumerate(tpipe.pad_boxes(pts[:g], 6))),
               dict(enumerate(jpipe.pad_boxes(pts[:g], 6))))

    # a scene with overlapping boxes: other-box candidates
    points, spec, owner = jsyn.detection_scene(np.random.default_rng(8),
                                               1500, 4, max_objects=8,
                                               room=2.2, min_objects=6)
    owner = owner.astype(np.int64)
    votes = np.zeros((len(points), 3), np.float32)
    vmask = owner >= 0
    votes[vmask] = spec.centers[owner[vmask]] - points[vmask]
    for V in (1, 2, 3, 4):
        args = (points, votes, vmask, owner, spec.centers, spec.sizes,
                spec.headings, V)
        got, want = tpipe.candidate_votes(*args), jpipe.candidate_votes(*args)
        _equal({"v": got}, {"v": want}, V)
    assert (want[:, 1] != want[:, 0]).any()  # some point is in two boxes
    _equal({"o": tpipe.recover_owner(points, votes, vmask, spec.centers)},
           {"o": jpipe.recover_owner(points, votes, vmask, spec.centers)})
    _equal({"o": tpipe.compact_owner(owner, 3)},
           {"o": jpipe.compact_owner(owner, 3)})
    for fn in (tpipe.compact_owner, jpipe.compact_owner):
        with pytest.raises(ValueError, match="127"):
            fn(owner, 128)
    for V in (1, 3):
        _equal(tpipe.scene_to_training_dict(points, spec, owner, 4, V),
               jpipe.scene_to_training_dict(points, spec, owner, 4, V), V)
    items = list(range(7))
    for t, j in zip(tpipe.iter_val_batches(items, lambda i: {"x": i}, 3),
                    jpipe.iter_val_batches(items, lambda i: {"x": i}, 3),
                    strict=True):
        _equal(t, j)


# ------------------------------------------------------------- Batcher


def _make(rng):
    return {"x": rng.random(4), "k": rng.integers(0, 9, 3)}


def test_batcher_stream_equals_reference():
    got, want = [], []
    for cls, out in ((tpipe.Batcher, got), (jpipe.Batcher, want)):
        b = cls(_make, seed=11, prefetch=2, num_batches=6)
        out.extend(_within(10, lambda b=b: list(b)))
        b.close()
    assert len(got) == 6
    for g, w in zip(got, want):
        _equal(g, w)


def test_batcher_loader_exception_reaches_the_consumer():
    def bad(rng):
        raise FileNotFoundError("scene gone")

    b = tpipe.Batcher(bad, prefetch=1)
    with pytest.raises(FileNotFoundError, match="scene gone"):
        _within(10, lambda: next(iter(b)))
    b.close()
    assert not b._thread.is_alive()


def test_batcher_finite_stream_ends():
    b = tpipe.Batcher(_make, num_batches=3)
    assert len(_within(10, lambda: list(b))) == 3
    b.close()
    assert not b._thread.is_alive()


def test_batcher_close_with_a_full_queue_does_not_hang():
    """A loader failure while the queue is full, and an endless stream
    blocked on a full queue: close() stops the thread either way."""
    calls = {"n": 0}

    def fails_third(rng):
        calls["n"] += 1
        if calls["n"] <= 2:
            return {"x": calls["n"]}
        raise RuntimeError("loader exploded")

    for make in (fails_third, _make):
        b = tpipe.Batcher(make, prefetch=1)
        time.sleep(0.3)  # the thread fills the queue and blocks
        _within(5, b.close)
        assert not b._thread.is_alive()


# ------------------------------------------------------ packing, prefetch


PACK_ARGS = ["data.name=scannet", f"data.num_points={POINTS}",
             "data.max_boxes=16", "data.augment=false", "data.use_color=true",
             "data.compact_votes=true"]


@pytest.fixture(scope="module")
def packs(roots, tmp_path_factory):
    """The port's ScanNet root packed by each package: {side: path}."""
    base = tmp_path_factory.mktemp("packs")
    tcfg, jcfg = _cfgs(PACK_ARGS + [f"data.root={roots['scannet'][0]}"])
    counts = (tpacked.pack_dataset(tget(tcfg, device="cpu"),
                                   str(base / "port")),
              jpacked.pack_dataset(jget(jcfg), str(base / "ref")))
    assert counts == ({"train": 4, "val": 3},) * 2
    return {"port": base / "port", "ref": base / "ref",
            "source": roots["scannet"][0]}


def test_packs_are_identical_and_read_alike_by_either_package(packs):
    _same_files(packs["port"], packs["ref"])
    for split in ("train", "val"):
        t = tpacked.PackedSplit(str(packs["ref"] / split))
        j = jpacked.PackedSplit(str(packs["port"] / split))
        assert t.header == j.header and len(t) == len(j)
        _equal(t.gather([2, 0, 1]), j.gather([2, 0, 1]))
        for i in range(len(t)):
            _equal(t.scene(i), j.scene(i), i)


def test_pack_is_bitwise_the_source_loader(packs):
    """Scene i of the pack is the loader's scene with default_rng(i)."""
    ds = tget(_cfgs(PACK_ARGS + [f"data.root={packs['source']}"])[0],
              device="cpu")
    split = tpacked.PackedSplit(str(packs["port"] / "train"))
    for i in range(len(split)):
        want = ds._load_scene(*ds.train_scans[i], np.random.default_rng(i),
                              False)
        _equal(split.scene(i), want, i)


def _packed_args(root, *extra):
    return ["data.name=packed", f"data.root={root}",
            f"data.num_points={POINTS}", "data.max_boxes=16",
            "data.use_color=true", *extra]


def test_packed_dataset_equals_reference(packs):
    tcfg, jcfg = _cfgs(_packed_args(packs["port"]))
    tds, jds = tget(tcfg, device="cpu"), jget(jcfg)
    assert (tds.source_dataset, tds.class_names, tds.steps_per_epoch(2)) == (
        jds.source_dataset, jds.class_names, jds.steps_per_epoch(2))
    np.testing.assert_array_equal(tds.mean_sizes, jds.mean_sizes)
    _equal(tds.train_batch(np.random.default_rng(4), 3),
           jds.train_batch(np.random.default_rng(4), 3))
    for t, j in zip(tds.val_batches(None, 2), jds.val_batches(None, 2),
                    strict=True):
        _equal(t, j)


@pytest.mark.parametrize("override,match", [
    ("data.num_points=1024", "num_points"),
    ("data.max_boxes=8", "max_boxes"),
    ("data.use_color=false", "point_features"),
], ids=["num_points", "max_boxes", "use_color"])
def test_packed_mismatch_raises_as_reference(packs, override, match):
    tcfg, jcfg = _cfgs(_packed_args(packs["port"], override))
    errors = []
    for fn, cfg in ((tget, tcfg), (jget, jcfg)):
        with pytest.raises(ValueError, match=match) as e:
            fn(cfg)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_device_prefetch_on_the_cpu_keeps_order_and_content(packs):
    ds = tget(_cfgs(_packed_args(packs["port"]))[0], device="cpu")
    host = [ds.train_batch(np.random.default_rng(i), 2) for i in range(5)]
    out = list(tpacked.device_prefetch(iter(host), "cpu", depth=2))
    assert len(out) == 5
    for h, d in zip(host, out):
        assert all(t.device.type == "cpu" for t in d.values())
        _equal({k: t.numpy() for k, t in d.items()}, h)
    # a mesh of this one process keeps every row; one with no 'data' axis
    # is refused (tests/test_torch_parallel_dp.py splits rows over 2 ranks)
    out = list(tpacked.device_prefetch(iter(host), "cpu",
                                       mesh=make_mesh((1,), ("data",))))
    for h, d in zip(host, out):
        _equal({k: t.numpy() for k, t in d.items()}, h)
    with pytest.raises(ValueError, match="no axis 'data'"):
        next(tpacked.device_prefetch(iter(host), "cpu",
                                     mesh=make_mesh((1,), ("points",))))
    blocks = [{k: np.stack([b[k] for b in host[i:i + 2]]) for k in host[0]}
              for i in (0, 2)]
    out = list(tpacked.device_prefetch(iter(blocks), "cpu", stacked=True))
    assert len(out) == 2
    for h, d in zip(blocks, out):
        assert all(t.shape[:2] == (2, 2) for t in d.values())
        _equal({k: t.numpy() for k, t in d.items()}, h)
    assert inspect.signature(tpacked.device_prefetch).parameters[
        "device"].default == "cuda"


# ------------------------------------------------------------- validate


def _corrupt(family, root):
    """Break a copy of a written root the ways validate reports."""
    d = root / "train"
    if family == "scannet":
        np.save(d / "scene0000_00_ins_label.npy", np.zeros(7, np.int64))
        v = np.load(d / "scene0001_00_vert.npy")
        v[0, 0] = np.nan
        np.save(d / "scene0001_00_vert.npy", v)
        np.save(d / "scene0002_00_bbox.npy", np.zeros((2, 5), np.float32))
        bb = np.load(d / "scene0003_00_bbox.npy")
        bb[0, 6] = 40  # not a benchmark nyu40 id: a warning
        np.save(d / "scene0003_00_bbox.npy", bb)
        v = np.load(d / "scene0003_00_vert.npy")
        v[:, 3:6] /= 255.0  # rgb 0-1: a warning
        np.save(d / "scene0003_00_vert.npy", v)
        np.save(d / "scene0003_00_sem_label.npy",
                np.full(len(v), -1, np.int32))
    elif family == "sunrgbd":
        n = np.load(d / "000000_pc.npy").shape[0]
        bad = np.zeros((n, 4), np.float32)
        bad[0, 0] = 0.5
        np.save(d / "000000_votes.npy", bad)
        np.save(d / "000001_votes.npy", np.zeros((n, 7), np.float32))
        pc = np.load(d / "000002_pc.npy")
        pc[:, 3:6] *= 255.0  # rgb 0-255: a warning
        np.save(d / "000002_pc.npy", pc)
        bb = np.load(d / "000003_bbox.npy")
        bb[0, 7] = 12
        bb[1, 4] = -1.0
        np.save(d / "000003_bbox.npy", bb)
        shutil.rmtree(root / "val")
    elif family == "kitti":
        pc = np.load(d / "000000_pc.npy")
        pc[:, 0] = -np.abs(pc[:, 0]) - 1.0  # behind the sensor
        np.save(d / "000000_pc.npy", pc)
        np.save(d / "000001_bbox.npy", np.ones((2, 7), np.float32))


@pytest.mark.parametrize("family", ["scannet", "sunrgbd", "kitti", "modelnet",
                                    "missing"])
def test_validate_reports_equal_reference(roots, family, tmp_path, capsys):
    """On good and broken scenes: the same errors, warnings and scene
    count, the same printed report and exit code."""
    good, broken = tmp_path / "good", tmp_path / "broken"
    name = family
    if family in ("scannet", "sunrgbd"):
        shutil.copytree(roots[family][0], good)
    elif family == "kitti":
        tso.write_dataset(str(good), scenes=2, val_scenes=1,
                          num_points=20000, seed=1)
    elif family == "modelnet":
        for split, cols in (("train", 3), ("test", 6)):
            (good / split).mkdir(parents=True)
            np.save(good / split / "chair_0000_pts.npy",
                    np.ones((40, cols), np.float32))
            np.save(good / split / "chair_0000_label.npy", np.int32(1))
        (good / "train" / "desk_0001_pts.npy").write_bytes(b"not npy")
        np.save(good / "train" / "desk_0001_label.npy", np.int32(-2))
    else:
        name = "scannet"
        good.mkdir()
    shutil.copytree(good, broken)
    _corrupt(family, broken)
    for root in (good, broken):
        t = tval.validate_root(name, str(root), max_scenes=5)
        j = jval.validate_root(name, str(root), max_scenes=5)
        assert (t.errors, t.warnings, t.scenes) == (j.errors, j.warnings,
                                                    j.scenes)
        codes = [fn([f"data.name={name}", f"root={root}"])
                 for fn in (tval.main, jval.main)]
        out = capsys.readouterr().out.splitlines()
        half = len(out) // 2
        assert codes[0] == codes[1] == int(bool(t.errors))
        assert out[:half] == out[half:]
    assert (family == "missing"
            or tval.validate_root(name, str(broken)).errors
            or tval.validate_root(name, str(broken)).warnings)
    with pytest.raises(SystemExit, match="contract"):
        tval.main(["data.name=synthetic", f"root={good}"])


# --------------------------------------------- one host-fed train step


def test_host_fed_train_step_matches_reference(roots):
    """A config-#3-shaped step (SMALL widths, 18 classes, ScanNet priors,
    colour features) on a ScanNet batch that came through the Batcher and
    device_prefetch, from bridged weights."""
    tcfg, _ = _cfgs([*TINY_MODEL, "data.name=scannet",
                     f"data.root={roots['scannet'][0]}",
                     f"data.num_points={POINTS}", "data.max_boxes=16",
                     "data.use_color=true"])
    ds = tget(tcfg, device="cpu")
    batcher = tpipe.Batcher(lambda rng: ds.train_batch(rng, 2), seed=0,
                            num_batches=1)
    (batch,) = list(tpacked.device_prefetch(batcher, "cpu"))
    batcher.close()
    host = ds.train_batch(np.random.default_rng(0), 2)  # the same stream
    _equal({k: t.numpy() for k, t in batch.items()}, host)
    assert batch["point_features"].shape == (2, POINTS, 3)

    ref_model = dataclasses.replace(SMALL, num_classes=18)
    jm = JDetector(ref_model, mean_sizes=tuple(map(tuple,
                                                   SCANNET_MEAN_SIZES)))
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    var = jax.jit(lambda k: jm.init(k, jb["points"], jb["point_features"],
                                    mask=jb["point_mask"], train=False))(
        jax.random.key(0))
    bn_m = train_lib.bn_momentum_at(tcfg.train, 0)

    def loss_fn(params):
        ep, upd = jm.apply({"params": params,
                            "batch_stats": var["batch_stats"]},
                           jb["points"], jb["point_features"],
                           mask=jb["point_mask"], train=True,
                           bn_momentum=bn_m, mutable=["batch_stats"])
        loss, _ = jlosses.detection_loss(ep, jb, SCANNET_MEAN_SIZES,
                                         ref_model.num_heading_bins,
                                         tuple(ref_model.cluster_radius_bank))
        return loss

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(var["params"])

    model = SizeAdaptiveDetector(to_port(ref_model), SCANNET_MEAN_SIZES,
                                 in_features=3, device="cpu")
    load_flax_variables(model, var)
    model.train()
    loss, _ = train_lib.detector_loss(model, tcfg, batch, bn_m)
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    params = dict(model.named_parameters())
    want = state_dict_from_flax({"params": jgrads}, params)
    gmax = max(g.abs().max().item() for g in want.values())
    for name, w in want.items():
        err = (params[name].grad - w).abs().max().item()
        assert err <= GRAD_RTOL * w.abs().max().item() + GRAD_ATOL * gmax, \
            name
    # colour, height and the 3 offsets of the grouped xyz
    assert params["backbone.sa1.mlp_0.dense_0.weight"].shape[1] == 7


# --------------------------------------------------------- run_detector


def _run_cfg(root, ckpt, name="scannet", *extra, classes=None):
    classes = classes or (10 if name == "sunrgbd" else 18)
    return tconfig.apply_overrides(tconfig.Config(), [
        *TINY_MODEL, f"model.num_classes={classes}", f"data.name={name}",
        f"data.root={root}", "data.num_points=1024", "data.max_boxes=16",
        "train.batch_size=2", "train.num_epochs=1", "train.eval_every=1",
        "train.log_every=1", f"train.ckpt_dir={ckpt}", *extra])


@pytest.fixture
def seen_datasets(monkeypatch):
    """The data configs run_detector builds its datasets from."""
    seen = []
    get = tdet.get_dataset

    def recording(cfg, **kw):
        seen.append(cfg.data)
        return get(cfg, **kw)

    monkeypatch.setattr(tdet, "get_dataset", recording)
    return seen


@pytest.mark.parametrize("name", ["scannet", "sunrgbd", "packed"])
def test_run_detector_trains_from_files(roots, name, tmp_path, capsys,
                                        seen_datasets):
    """One epoch of 2 host-fed steps and the val sweep: ScanNet with
    colour and host augmentation, SUN RGB-D, and a packed ScanNet split
    with compact votes and augmentation on the device."""
    ckpt = tmp_path / "ckpt"
    if name == "packed":
        src = tconfig.apply_overrides(tconfig.Config(), [
            "data.name=scannet", f"data.root={roots['scannet'][0]}",
            "data.num_points=1024", "data.max_boxes=16", "data.augment=false",
            "data.compact_votes=true"])
        tpacked.pack_dataset(tget(src, device="cpu"), str(tmp_path / "pk"))
        cfg = _run_cfg(tmp_path / "pk", ckpt, "packed",
                       "data.device_augment=true", "data.compact_votes=true")
    else:
        cfg = _run_cfg(roots[name][0], ckpt, name,
                       *(["data.use_color=true"] if name == "scannet" else []))
    result = tdet.run_detector(cfg, device="cpu")
    (data,) = seen_datasets
    assert data.augment == (name != "packed")  # canonical under device aug
    assert (result.start_step, result.step) == (0, 2)
    assert np.isfinite([h["loss"] for h in result.history]).all()
    assert all(0 <= h["wait"] <= h["seconds"] for h in result.history)
    (m,) = result.evals
    assert (m["epoch"], m["step"]) == (0, 2) and m["seconds"] > 0
    assert 0.0 <= m["mAP@0.25"] <= 1.0 and np.isfinite(m["val_loss"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    (logged,) = [r for r in rows if "eval/mAP@0.25" in r]
    assert logged["eval/mAP@0.25"] == m["mAP@0.25"] and logged["step"] == 2
    assert any("per_class@0.25" in r for r in rows)
    assert json.loads((ckpt / "best.json").read_text()) == {
        "metric": m["mAP@0.25"], "step": 2}
    assert sorted(os.listdir(ckpt / "best")) == ["ckpt_2.pt"]


def test_best_snapshot_restore_resume_and_train_mode(roots, tmp_path,
                                                     monkeypatch):
    """Two epochs with a sweep after each: every train step runs in train
    mode with BatchNorm in train mode, also after a sweep; best.json holds
    the best logged mAP; restore(use_best=True) and evaluate give it
    again; auto-resume takes the newest checkpoint, never best/."""
    ckpt = tmp_path / "ckpt"
    cfg = _run_cfg(roots["scannet"][0], ckpt, "scannet",
                   "data.use_color=true", "train.num_epochs=2")
    modes = []
    loss_fn = train_lib.detector_loss

    def recording(model, *args):
        modes.append(all(m.training for m in model.modules()))
        return loss_fn(model, *args)

    monkeypatch.setattr(train_lib, "detector_loss", recording)
    first = tdet.run_detector(cfg, device="cpu")
    assert modes == [True] * 4 and first.step == 4
    maps = [e["mAP@0.25"] for e in first.evals]
    best = {"metric": max(maps), "step": 2 * (maps.index(max(maps)) + 1)}
    assert json.loads((ckpt / "best.json").read_text()) == best

    dataset = tget(cfg, device="cpu")
    fresh = tdet.build_detector(cfg, dataset.mean_sizes, device="cpu")
    assert train_lib.restore_checkpoint(str(ckpt), fresh, None, for_eval=True,
                                        use_best=True) == best["step"]
    again = tdet.evaluate(
        cfg, fresh, dataset, train_lib.make_detector_eval_step(fresh, cfg),
        lambda ep: parse_predictions(ep, fresh.mean_sizes,
                                     cfg.model.num_heading_bins, cfg.eval))
    assert again["mAP@0.25"] == best["metric"]

    optim = train_lib.make_optimizer(cfg.train, 2, fresh.parameters())
    assert train_lib.save_best_checkpoint(str(ckpt), fresh, optim, 999, 2.0)
    resumed = tdet.run_detector(cfg, device="cpu")
    assert (resumed.start_step, resumed.step, resumed.history) == (4, 4, [])
    longer = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=3))
    more = tdet.run_detector(longer, device="cpu")
    assert (more.start_step, more.step, more.optimizer.count) == (4, 6, 6)
    assert json.loads((ckpt / "best.json").read_text())["step"] == 999


def test_save_best_checkpoint_writes_only_on_improvement(tmp_path):
    """As tests/e2e/test_best_checkpoint.py holds the reference: better
    writes, equal or worse does not, exactly one snapshot is kept."""
    cfg = tconfig.TrainConfig(lr_decay_steps=(), lr_decay_rates=())
    model = torch.nn.Linear(2, 2)
    optim = train_lib.make_optimizer(cfg, 10, model.parameters())
    d = tmp_path / "ckpt"

    def with_weight(w):
        torch.nn.init.constant_(model.weight, w)
        return model

    assert train_lib.save_best_checkpoint(str(d), with_weight(1.0), optim,
                                          10, 0.30)
    assert json.loads((d / "best.json").read_text()) == {"metric": 0.30,
                                                         "step": 10}
    for metric in (0.25, 0.30):
        assert not train_lib.save_best_checkpoint(
            str(d), with_weight(99.0), optim, 20, metric)
    assert train_lib.save_best_checkpoint(str(d), with_weight(7.0), optim,
                                          30, 0.55)
    assert sorted(os.listdir(d / "best")) == ["ckpt_30.pt"]
    assert train_lib.restore_checkpoint(str(d), with_weight(0.0), None,
                                        for_eval=True, use_best=True) == 30
    assert (model.weight == 7.0).all()
    assert train_lib.restore_checkpoint(str(d), model, None,
                                        for_eval=True) == 0  # no latest
    assert train_lib.restore_checkpoint(str(tmp_path / "none"), model, None,
                                        use_best=True) == 0


def test_run_detector_closes_the_batcher_when_a_step_raises(
        roots, tmp_path, monkeypatch):
    made = []

    class Recording(tpipe.Batcher):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    def failing_steps(*args, **kw):
        def step(batch, generator, bn_momentum):
            raise RuntimeError("step failed")
        return step

    monkeypatch.setattr(tdet, "Batcher", Recording)
    monkeypatch.setattr(train_lib, "make_detector_steps", failing_steps)
    cfg = _run_cfg(roots["scannet"][0], tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="step failed"):
        tdet.run_detector(cfg, device="cpu")
    (batcher,) = made
    assert not batcher._thread.is_alive()


def test_packed_with_host_augmentation_is_refused(packs, tmp_path):
    cfg = _run_cfg(packs["port"], tmp_path / "ckpt", "packed",
                   "data.use_color=true", f"data.num_points={POINTS}")
    with pytest.raises(ValueError, match="device_augment"):
        tdet.run_detector(cfg, device="cpu")
    assert not (tmp_path / "ckpt").exists()


def test_packed_sunrgbd_split_augments_by_the_sunrgbd_recipe(
        roots, tmp_path, monkeypatch, capsys):
    """The pack's header names its source, and the train step's
    augmentation on the device takes that source's recipe, as the
    reference's aug_dataset does (a packed split is not ScanNet)."""
    args = ["data.name=sunrgbd", f"data.root={roots['sunrgbd'][0]}",
            "data.num_points=1024", "data.max_boxes=16"]
    tpacked.main(args + [f"out={tmp_path / 'port'}"])
    jpacked.main(args + [f"out={tmp_path / 'ref'}"])
    printed = [json.loads(line)["packed"]
               for line in capsys.readouterr().out.splitlines()]
    assert printed == [{"train": 4, "val": 3}] * 2
    _same_files(tmp_path / "port", tmp_path / "ref")
    seen = []
    augment = train_lib.augment_batch

    def recording(batch, generator, **recipe):
        seen.append(recipe)
        return augment(batch, generator, **recipe)

    monkeypatch.setattr(train_lib, "augment_batch", recording)
    cfg = _run_cfg(tmp_path / "port", tmp_path / "ckpt", "packed",
                   "data.device_augment=true", "train.batch_size=4",
                   "train.eval_every=5", classes=10)
    result = tdet.run_detector(cfg, device="cpu")
    assert result.step == 1 and result.evals == []
    assert tget(cfg, device="cpu").source_dataset == "sunrgbd"
    _, jcfg = _cfgs(["data.device_augment=true"])
    assert seen == [jaug.resolve_aug(jcfg.data, "sunrgbd")]
    assert seen[0] != taug.AUG_PRESETS["scannet"]
