"""The port's raw-release converters (tpu3dsad_torch/data/preproc_scannet,
preproc_kitti, preproc_sunrgbd) held against the JAX package's on the
same raw fixtures, written from a seed by the reference's own fixture
writers (tests/e2e/test_preproc_*.py).

Tolerance: none. Every .npy file, every array a reader returns and every
split assignment is bitwise the reference's (the same numpy code on the
same bytes); a malformed input exits with the reference's code and
message. Each converter's output then passes the port's validator and
feeds the port's loader one train batch.
"""

import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from tests.e2e.test_preproc_kitti import _write_scene as write_kitti_scene
from tests.e2e.test_preproc_scannet import _write_ply, _write_raw_scene
from tests.e2e.test_preproc_sunrgbd import _basis_rows, _write_raw_tree
from tpu3dsad.data import preproc_kitti as j_kitti
from tpu3dsad.data import preproc_scannet as j_scannet
from tpu3dsad.data import preproc_sunrgbd as j_sunrgbd
from tpu3dsad_torch.config import parse_cli
from tpu3dsad_torch.data import get_dataset
from tpu3dsad_torch.data import preproc_kitti as t_kitti
from tpu3dsad_torch.data import preproc_scannet as t_scannet
from tpu3dsad_torch.data import preproc_sunrgbd as t_sunrgbd
from tpu3dsad_torch.data.validate import validate_root

LABELS = [
    "id\traw_category\tcategory\tnyu40id\tnyu40class",
    "2\tchair\tchair\t5\tchair",
    "7\tdining table\ttable\t7\ttable",
    "1\twall\twall\t1\twall",
    "9\tunmapped thing\tmisc\t\t",
]
SCENES = ("scene0000_00", "scene0001_00", "scene0002_00", "scene0003_00")


def files_of(root) -> dict:
    """{path relative to root: bytes} of every file under root."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def require_same_tree(got_root, want_root):
    got, want = files_of(got_root), files_of(want_root)
    assert sorted(got) == sorted(want)
    assert want
    for name in want:
        assert got[name] == want[name], name


def run_main(module, argv, capsys) -> tuple:
    """(return code, stdout, stderr) of module.main(argv)."""
    rc = module.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


# ------------------------------------------------------------- ScanNet


@pytest.mark.parametrize("fmt,alpha", [("binary_little_endian", True),
                                       ("binary_little_endian", False),
                                       ("ascii", True), ("ascii", False)])
def test_ply_reader_equals_reference(tmp_path, fmt, alpha):
    rng = np.random.default_rng(3)
    xyz = rng.standard_normal((23, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (23, 3))
    path = str(tmp_path / "m.ply")
    _write_ply(path, xyz, rgb, fmt=fmt, alpha=alpha)
    got = t_scannet.read_ply_vertices(path)
    assert got.dtype == np.float32 and got.shape == (23, 6)
    np.testing.assert_array_equal(got, j_scannet.read_ply_vertices(path))


def test_ply_reader_without_colour_equals_reference(tmp_path):
    """A vertex table of xyz only reads as rgb zeros."""
    xyz = np.random.default_rng(4).standard_normal((9, 3)).astype(np.float32)
    header = ["ply", "format binary_little_endian 1.0", "element vertex 9",
              "property float x", "property float y", "property float z",
              "end_header"]
    path = tmp_path / "plain.ply"
    path.write_bytes(("\n".join(header) + "\n").encode()
                     + b"".join(struct.pack("<fff", *p) for p in xyz))
    got = t_scannet.read_ply_vertices(str(path))
    np.testing.assert_array_equal(got[:, 3:], 0)
    np.testing.assert_array_equal(got, j_scannet.read_ply_vertices(str(path)))


def _write_scannet(tmp_path, seed=0):
    """Four raw scans of 360 vertices (tests/e2e's writer), the label TSV
    and split lists; returns (scans, labels)."""
    rng = np.random.default_rng(seed)
    scans = str(tmp_path / "scans")
    # written out of order: the converters sort the scan list
    for scene in SCENES[::-1]:
        _write_raw_scene(scans, scene, rng)
    labels = tmp_path / "labels.tsv"
    labels.write_text("\n".join(LABELS) + "\n")
    (tmp_path / "train.txt").write_text("scene0000_00\nscene0001_00\n")
    (tmp_path / "val.txt").write_text("scene0003_00\n")
    return scans, str(labels)


@pytest.mark.parametrize("lists,max_points", [(False, 50000), (True, 200)])
def test_scannet_export_all_equals_reference(tmp_path, capsys, lists,
                                             max_points):
    """Every file bitwise the reference's, the same splits; at max_points
    200 every scene of 360 vertices is subsampled, with the seed of its
    place in the sorted scan list (scene0002_00, in neither list, is
    skipped under lists but still counts for the seeds after it)."""
    scans, labels = _write_scannet(tmp_path)
    args = [f"scans={scans}", f"labels={labels}", f"max_points={max_points}"]
    if lists:
        args += [f"train_list={tmp_path / 'train.txt'}",
                 f"val_list={tmp_path / 'val.txt'}"]
    outs = {}
    for name, module in (("port", t_scannet), ("ref", j_scannet)):
        outs[name] = run_main(module, [*args, f"out={tmp_path / name}"],
                              capsys)
        assert outs[name][0] == 0
    assert (json.loads(outs["port"][1])["written"]
            == json.loads(outs["ref"][1])["written"])
    require_same_tree(tmp_path / "port", tmp_path / "ref")
    vert = np.load(tmp_path / "port" / "train" / "scene0001_00_vert.npy")
    assert len(vert) == min(max_points, 360)


@pytest.mark.parametrize("fault", ["missing_segs", "truncated_header",
                                   "not_ply", "no_scans"])
def test_scannet_malformed_input_exits_as_reference(tmp_path, capsys, fault):
    scans, labels = _write_scannet(tmp_path)
    p = os.path.join(scans, "scene0001_00", "scene0001_00")
    if fault == "missing_segs":
        os.remove(p + "_vh_clean_2.0.010000.segs.json")
    elif fault == "truncated_header":
        with open(p + "_vh_clean_2.ply", "wb") as f:
            f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 3\n")
    elif fault == "not_ply":
        with open(p + "_vh_clean_2.ply", "wb") as f:
            f.write(b"solid mesh\n")
    else:
        scans = str(tmp_path / "empty")
    args = [f"scans={scans}", f"labels={labels}", f"out={tmp_path / 'o'}"]
    got = run_main(t_scannet, args, capsys)
    want = run_main(j_scannet, args, capsys)
    assert got[0] == want[0] == 1
    assert got[2] == want[2] and "preproc_scannet: " in got[2]


def test_scannet_output_validates_and_loads(tmp_path, capsys):
    scans, labels = _write_scannet(tmp_path)
    out = str(tmp_path / "npy")
    assert t_scannet.main([f"scans={scans}", f"labels={labels}",
                           f"out={out}",
                           f"val_list={tmp_path / 'val.txt'}"]) == 0
    assert validate_root("scannet", out).errors == []
    cfg = parse_cli(["data.name=scannet", f"data.root={out}",
                     "data.num_points=256", "data.max_boxes=8",
                     "data.use_color=true"])
    ds = get_dataset(cfg, device="cpu")
    assert (len(ds.train_scans), len(ds.val_scans)) == (3, 1)
    batch = ds.train_batch(np.random.default_rng(0), 2)
    assert batch["points"].shape == (2, 256, 3)
    assert batch["point_features"].shape == (2, 256, 3)
    assert batch["gt_mask"].sum() == 4  # a chair and a table a scene


# ---------------------------------------------------------------- KITTI

KITTI_BOXES = [
    ((10.0, 3.0, -0.75), (3.9, 1.6, 1.5), 0.3, "Car"),
    ((20.0, -5.0, -0.9), (0.8, 0.6, 1.8), -1.2, "Pedestrian"),
    ((15.0, 0.0, -0.8), (1.8, 0.6, 1.7), 2.5, "Cyclist"),
    ((30.0, 8.0, -0.5), (5.5, 2.1, 2.3), 0.0, "Van"),  # dropped
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0.0, "DontCare"),  # dropped
]


def _write_kitti(tmp_path, r0_angle, n=3):
    """n scans of 600 points in the crop range with the boxes above, R0_rect
    a turn of r0_angle; scan 000002 is val."""
    rng = np.random.default_rng(5)
    root = str(tmp_path / "raw")
    for i in range(n):
        pc = rng.random((600, 4)) * [50, 40, 3, 1] + [5, -20, -2.5, 0]
        write_kitti_scene(root, f"{i:06d}", pc, KITTI_BOXES[i % 2:], r0_angle)
    (tmp_path / "val.txt").write_text("000002\n")
    return root


@pytest.mark.parametrize("r0_angle", [0.0, 0.05])
def test_kitti_export_all_equals_reference(tmp_path, capsys, r0_angle):
    root = _write_kitti(tmp_path, r0_angle)
    for name, module in (("port", t_kitti), ("ref", j_kitti)):
        rc, out, _ = run_main(module, [
            f"root={root}", f"out={tmp_path / name}",
            f"val_list={tmp_path / 'val.txt'}"], capsys)
        assert rc == 0 and '"train": 2, "val": 1' in out
    require_same_tree(tmp_path / "port", tmp_path / "ref")
    calib = os.path.join(root, "training", "calib", "000000.txt")
    for key, value in t_kitti.read_calib(calib).items():
        np.testing.assert_array_equal(value, j_kitti.read_calib(calib)[key])
    bbox = np.load(tmp_path / "port" / "train" / "000000_bbox.npy")
    assert bbox.shape == (3, 8)  # Van and DontCare dropped


@pytest.mark.parametrize("fault", ["odd_bin", "missing_calib", "no_scans"])
def test_kitti_malformed_input_exits_as_reference(tmp_path, capsys, fault):
    root = _write_kitti(tmp_path, 0.0)
    split = os.path.join(root, "training")
    if fault == "odd_bin":
        with open(os.path.join(split, "velodyne", "000001.bin"), "ab") as f:
            f.write(b"\x00\x00\x00\x00")
    elif fault == "missing_calib":
        os.remove(os.path.join(split, "calib", "000001.txt"))
    else:
        root = str(tmp_path / "empty")
    args = [f"root={root}", f"out={tmp_path / 'o'}"]
    got = run_main(t_kitti, args, capsys)
    want = run_main(j_kitti, args, capsys)
    assert got[0] == want[0] == 1
    assert got[2] == want[2] and "preproc_kitti: " in got[2]


def test_kitti_output_validates_and_loads(tmp_path):
    root = _write_kitti(tmp_path, 0.05)
    out = str(tmp_path / "npy")
    t_kitti.export_all(root, out, val_list=str(tmp_path / "val.txt"))
    assert validate_root("kitti", out).errors == []
    cfg = parse_cli(["preset=outdoor", f"data.root={out}",
                     "data.num_points=256", "data.max_boxes=8",
                     "data.augment=false"])
    ds = get_dataset(cfg, device="cpu")
    batch = ds.train_batch(np.random.default_rng(0), 2)
    assert batch["points"].shape == (2, 256, 3)
    assert batch["gt_mask"].any()


# ------------------------------------------------------------ SUN RGB-D


@pytest.mark.parametrize("z_row_first", [False, True])
def test_sunrgbd_convert_box_equals_reference(z_row_first):
    basis, half = _basis_rows(0.6), np.array([0.8, 0.4, 0.3])
    if z_row_first:  # either basis row order
        basis, half = basis[[2, 0, 1]], half[[2, 0, 1]]
    args = (basis, half, np.array([1.0, 2.0, 0.5]), "bed")
    got = t_sunrgbd.convert_box(*args)
    np.testing.assert_array_equal(got, j_sunrgbd.convert_box(*args))
    assert t_sunrgbd.convert_box(np.eye(3), np.ones(3), np.zeros(3),
                                 "whiteboard") is None


def test_sunrgbd_depth_to_points_equals_reference():
    rng = np.random.default_rng(6)
    depth = rng.uniform(0.0, 5.0, (12, 16)).astype(np.float32)
    depth[depth < 0.5] = 0.0
    k = np.array([[90.0, 0, 8.0], [0, 90.0, 6.0], [0, 0, 1.0]])
    a = 0.1
    rtilt = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                      [0, np.sin(a), np.cos(a)]])
    rgb = rng.integers(0, 255, (12, 16, 3)).astype(np.uint8)
    for colour in (rgb, None):
        np.testing.assert_array_equal(
            t_sunrgbd.depth_to_points(depth, k, rtilt, colour),
            j_sunrgbd.depth_to_points(depth, k, rtilt, colour))


@pytest.mark.parametrize("num_points", [50000, 100])
def test_sunrgbd_export_all_equals_reference(tmp_path, capsys, num_points):
    """At num_points 100 each scene of 192 pixels is subsampled with the
    seed of its place in the meta; the votes are data/sunrgbd.py's."""
    meta, root, _ = _write_raw_tree(tmp_path)
    (tmp_path / "val.txt").write_text("000002\n")
    for name, module in (("port", t_sunrgbd), ("ref", j_sunrgbd)):
        rc, out, _ = run_main(module, [
            f"meta={meta}", f"root={root}", f"out={tmp_path / name}",
            f"val_list={tmp_path / 'val.txt'}",
            f"num_points={num_points}"], capsys)
        assert rc == 0 and '"train": 2, "val": 1' in out
    require_same_tree(tmp_path / "port", tmp_path / "ref")
    pc = np.load(tmp_path / "port" / "val" / "000002_pc.npy")
    assert len(pc) == min(num_points, 192)


def test_sunrgbd_without_pil_names_the_converter(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="preproc_sunrgbd.*PIL"):
        t_sunrgbd.read_depth(str(tmp_path / "d.png"))


@pytest.mark.parametrize("fault", ["missing_meta", "missing_depth"])
def test_sunrgbd_malformed_input_exits_as_reference(tmp_path, capsys,
                                                    fault):
    meta, root, _ = _write_raw_tree(tmp_path, n_scenes=2)
    if fault == "missing_meta":
        meta = str(tmp_path / "absent.mat")
    else:
        os.remove(os.path.join(root, "SUNRGBD", "kv1", "scene1", "depth",
                               "0001.png"))
    args = [f"meta={meta}", f"root={root}", f"out={tmp_path / 'o'}"]
    got = run_main(t_sunrgbd, args, capsys)
    want = run_main(j_sunrgbd, args, capsys)
    assert got[0] == want[0] == 1
    assert got[2] == want[2] and "preproc_sunrgbd: " in got[2]


def test_sunrgbd_output_validates_and_loads(tmp_path):
    meta, root, (center, size, heading) = _write_raw_tree(tmp_path)
    out = str(tmp_path / "npy")
    t_sunrgbd.export_all(meta, root, out)
    assert validate_root("sunrgbd", out).errors == []
    cfg = parse_cli(["data.name=sunrgbd", f"data.root={out}",
                     "data.num_points=128", "data.max_boxes=8",
                     "data.augment=false"])
    ds = get_dataset(cfg, device="cpu")
    batch = ds.train_batch(np.random.default_rng(0), 2)
    assert batch["points"].shape == (2, 128, 3)
    gt = batch["gt_mask"]
    assert gt.sum() == 2  # one bed a scene
    np.testing.assert_allclose(batch["gt_centers"][gt][0], center,
                               atol=1e-5)
    np.testing.assert_allclose(batch["gt_headings"][gt][0], heading,
                               atol=1e-5)
