"""3DSSD (models/ssd3d.py, model.name='ssd3d') on the port's path: the
feature-space FPS op, fusion sampling, the decode and parse, the factory
and preset, and the served program held to the benchmark's plain
reference (portbench/reference/ssd3d.py).

On the CPU, at a small size (2 clouds of 2048 points, the sampling counts
scaled down, the published MLP widths):

  * the plain F-FPS equals a brute-force numpy loop (fp32, summed in
    dimension order), ties to the lowest index, masked points never
    picked; over xyz alone it is the D-FPS op's picks;
  * fusion sampling: "FS" is F-FPS's picks then D-FPS's over the same
    range, SA3's split ranges each sample their own part, offset into the
    level's input;
  * the decode clamps sizes at 0.1 m and wraps headings above pi, the vote
    offsets are clamped per axis, the parse keeps the first 100 survivors
    by score (ties to the lower slot);
  * the served program (seeded weights, calibrated BatchNorm) equals the
    reference: every sampler's picks equal, the six fields within the
    benchmark's tolerances (1e-5 and below in practice), keep equal; the
    reference's weight list is the program's;
  * preset=3dssd builds 3DSSD through train_detector.build_detector, the
    factory of serving and evaluation; it serves through
    serving.build_inference_fn, evaluates through eval_detector.run_eval
    on a KITTI-format split (the loader feeds its intensity), exports with
    one node per feature-FPS call; the spans of a forward;
  * the launch plans, and the refusal of a cloud past 8 CTAs' shared
    memory.

On the card (`card` tests, skipped without one): the kernel's picks equal
the plain op's at the cell's shapes (B = 16: 4096 x 67 -> 512,
512 x 131 -> 256), on ragged shapes, masks, ties and the largest cloud 8
CTAs' shared memory holds at 67 values, and over xyz alone equal B1's. This file imports no JAX, so on the card:
    python -m pytest tests/test_torch_ssd3d.py --noconftest -m card
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from portbench import weights  # noqa: E402
from portbench.drivers.ssd3d import pick_mismatches, recorded  # noqa: E402
from portbench.harness import Context  # noqa: E402
from portbench.reference import compare  # noqa: E402
from portbench.reference import ssd3d as reference  # noqa: E402
from tpu3dsad_torch import ops, serving, train_lib  # noqa: E402
from tpu3dsad_torch.config import Config, ModelConfig, parse_cli  # noqa: E402
from tpu3dsad_torch.eval.parse import top_scores  # noqa: E402
from tpu3dsad_torch.models.ssd3d import SSD3D, decode  # noqa: E402
from tpu3dsad_torch.nn import SetAbstraction  # noqa: E402
from tpu3dsad_torch.ops.plain import feature_fps  # noqa: E402
from tpu3dsad_torch.train_detector import build_detector  # noqa: E402
from tpu3dsad_torch.utils import trace  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
B, N = 2, 2048
# the sampling counts scaled down (published: 4096, 512 + 512, 256 + 256)
SMALL = dict(ssd3d_npoints=[[512], [64], [32, 32]],
             ssd3d_fps_ranges=[[-1], [-1], [64, -1]])
SMALL_ARGS = ["model.ssd3d_npoints=((512,),(64,),(32,32))",
              "model.ssd3d_fps_ranges=((-1,),(-1,),(64,-1))",
              "data.num_points=2048"]


def small_config() -> dict:
    cfg = json.loads((REPO / "portbench" / "configs"
                      / "3dssd-kitti-car-16k.json").read_text())
    cfg["model"].update(SMALL)
    cfg["data"]["num_points"] = N
    return cfg


def port_config(config: dict):
    return Context.port_config(SimpleNamespace(config=config))


def cloud(seed: int):
    """Points [B, N, 3] over a KITTI-like range, intensity [B, N, 1], a
    mask with a padded tail in cloud 1."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, -20, -2], [40, 20, 1], (B, N, 3)).astype(np.float32)
    feats = rng.random((B, N, 1)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, 1900:] = False
    return (torch.from_numpy(pts), torch.from_numpy(feats),
            torch.from_numpy(mask))


@pytest.fixture(autouse=True)
def tracer_off():
    trace.enable(False)
    trace.collect()
    yield
    trace.enable(False)
    trace.collect()


# ------------------------------------------------------------- F-FPS


def brute_ffps(x: np.ndarray, m: int, valid: np.ndarray) -> np.ndarray:
    """numpy F-FPS of one cloud x [N, D] float32: the running minimum of
    the squared distance summed in dimension order, first maximum."""
    n, d = x.shape
    dist = np.where(valid, np.float32(np.inf), np.float32(-np.inf))
    out, last = [0], 0
    for _ in range(1, m):
        d2 = np.zeros(n, np.float32)
        for k in range(d):
            diff = (x[:, k] - x[last, k]).astype(np.float32)
            d2 = (d2 + diff * diff).astype(np.float32)
        dist = np.minimum(dist, np.where(valid, d2, -np.inf)).astype(
            np.float32)
        last = int(np.argmax(dist))
        out.append(last)
    return np.asarray(out)


FFPS_CASES = {
    "d67": (60, 67, 20, False, False),
    "d131-masked": (50, 131, 30, True, False),
    "ties-on-a-grid": (64, 5, 40, False, True),
    "d4-masked-ties": (48, 4, 48, True, True),
}


@pytest.mark.parametrize("case", FFPS_CASES, ids=list(FFPS_CASES))
def test_plain_ffps_equals_a_brute_force_loop(case):
    n, d, m, masked, ties = FFPS_CASES[case]
    rng = np.random.default_rng(n + d)
    x = (rng.integers(0, 3, (2, n, d)) if ties
         else rng.normal(size=(2, n, d))).astype(np.float32)
    valid = np.ones((2, n), bool)
    if masked:
        valid[0, ::3] = False
        valid[1, n // 2:] = False
        m = min(m, n // 2)
    got = feature_fps(torch.from_numpy(x), m, torch.from_numpy(valid))
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(),
                                      brute_ffps(x[b], m, valid[b]))
        # the seed is index 0 whatever its mask; no later pick is masked
        assert valid[b, got[b, 1:].numpy()].all()


def test_ffps_over_xyz_alone_is_dfps_and_the_op_dispatches():
    pts, _, mask = cloud(1)
    want = ops.furthest_point_sample(pts, 100, mask=mask)
    assert torch.equal(ops.feature_furthest_point_sample(pts, 100,
                                                         mask=mask), want)
    assert torch.equal(reference.ffps(pts, 100, mask), want)


@pytest.mark.parametrize("masked", [False, True])
def test_ffps_op_passes_opcheck(masked):
    """Schema, fake version, autograd registration and AOT dispatch of the
    custom op tpu3dsad_torch::ffps on the CPU; its output is the plain
    version's."""
    from tpu3dsad_torch.ops import library

    pts, feats, mask = cloud(8)
    vec = torch.cat([pts, feats], -1)[:, :64]
    args = (vec, 16, mask[:, :64] if masked else None)
    torch.library.opcheck(library.ffps, args)
    assert torch.equal(library.ffps(*args), feature_fps(*args))


@pytest.mark.parametrize("shape,want", [
    # SA2: 8 x 139 KB of shared memory first, down to the 5 CTAs that hold
    # a cloud's 1.1 MB
    ((16, 4096, 67), [(8, 512, 1), (7, 320, 2), (6, 352, 2), (5, 416, 2)]),
    ((16, 512, 131), [(4, 128, 1), (3, 192, 1), (2, 256, 1)]),  # SA3
    ((2, 33, 131), [(1, 64, 1)]),
    # 32 clouds fill the card at 4 CTAs, whose slices do not fit: the
    # larger clusters up to 8 that hold them
    ((32, 4096, 67), [(5, 416, 2), (6, 352, 2), (7, 320, 2), (8, 512, 1)]),
    # the most that 8 CTAs' shared memory holds at 67 values a point
    ((1, 6768, 67), [(8, 448, 2)]),
    # over xyz alone, the most that 8 CTAs of 512 threads hold
    ((1, 65536, 3), [(8, 512, 16)]),
], ids=["sa2", "sa3", "small", "wide-batch", "largest-67", "largest-xyz"])
def test_ffps_plan(shape, want):
    from tpu3dsad_torch.ops.cuda import ffps as cuda_ffps

    got = cuda_ffps.plan(*shape, 132)
    assert [tuple(p) for p in got] == want
    for p in got:
        assert p.cluster * p.threads * p.points >= shape[1]
        assert p.cluster <= cuda_ffps.MAX_CLUSTER
    assert cuda_ffps.row_float4s(shape[2]) % 2 == 1


@pytest.mark.parametrize("shape", [(1, 6769, 67), (1, 70000, 67),
                                   (1, 65537, 3), (16, 4096, 1000)],
                         ids=["past-67", "memory-tier-gone", "past-xyz",
                              "wide-rows"])
def test_ffps_plan_refuses_clouds_past_8_ctas_shared_memory(shape):
    """No tier reads a cloud from global memory: a cloud whose slices fit
    no portable cluster's shared memory, or 8 CTAs of 512 threads at 16
    points a thread, is refused before any launch."""
    from tpu3dsad_torch.ops.cuda import ffps as cuda_ffps

    with pytest.raises(ValueError, match="shared memory of at most 8 CTAs"):
        cuda_ffps.plan(*shape, 132)


# ------------------------------------------------------------- sampling


@pytest.mark.parametrize("level", [1, 2])
def test_fusion_sampling_ranges(level):
    """SA2's "FS": F-FPS then D-FPS over all points; SA3's split ranges:
    F-FPS over [0, 64), D-FPS over [64, 128), offset into the input."""
    torch.manual_seed(level)
    xyz = torch.rand(B, 128, 3) * 10
    feats = torch.rand(B, 128, 16)
    mask = torch.ones(B, 128, dtype=torch.bool)
    mask[0, 100:] = False
    spec = ((("FS", -1, 32),) if level == 1
            else (("F-FPS", 64, 16), ("D-FPS", -1, 16)))
    sa = SetAbstraction(64 if level == 1 else 32, (1.0,), (8,), ((8,),),
                        in_features=16, sampling=spec)
    got = sa.sample(xyz, feats, mask)
    vec = torch.cat([xyz, feats], -1)
    if level == 1:
        want = torch.cat([feature_fps(vec, 32, mask),
                          ops.furthest_point_sample(xyz, 32, mask=mask)], 1)
    else:
        want = torch.cat([
            feature_fps(vec[:, :64], 16, mask[:, :64]),
            ops.furthest_point_sample(xyz[:, 64:].contiguous(), 16,
                                      mask=mask[:, 64:]) + 64], 1)
    assert torch.equal(got, want)
    assert got.shape == (B, sa.npoint)


def test_sampling_counts_are_checked():
    with pytest.raises(ValueError, match="npoint"):
        SetAbstraction(10, (1.0,), (4,), ((4,),), sampling=(("FS", -1, 4),))
    with pytest.raises(ValueError, match="mode"):
        SetAbstraction(4, (1.0,), (4,), ((4,),), sampling=(("R-FPS", -1, 4),))


# ------------------------------------------------------------- decode


def test_decode_clamps_sizes_and_wraps_headings():
    NH = 12
    raw = torch.zeros(1, 3, 6 + 2 * NH)
    raw[0, :, 3:6] = torch.tensor([[0.01, -1.0, 1.0]] * 3)
    raw[0, 0, 6 + 11] = 5.0  # bin 11: 11 pi / 6 + residual, above pi
    raw[0, 0, 6 + NH + 11] = 0.5
    raw[0, 1, 6 + 2] = 5.0  # bin 2: pi / 3 - pi / 12
    raw[0, 1, 6 + NH + 2] = -1.0
    raw[0, 2, 6 + 6] = 5.0  # bin 6: pi + residual 0, not above pi
    votes = torch.tensor([[[1.0, 2.0, 3.0]] * 3])
    out = decode(raw, votes, NH)
    np.testing.assert_allclose(out["size"][0, 0].numpy(), [0.1, 0.1, 2.0])
    want = [11 * np.pi / 6 + 0.5 * np.pi / 12 - 2 * np.pi,
            np.pi / 3 - np.pi / 12, np.pi]
    np.testing.assert_allclose(out["heading"][0].numpy(), want, rtol=1e-6)
    assert torch.equal(out["center"], votes)


def test_vote_offsets_are_clamped_per_axis():
    cfg = port_config(small_config())
    model = SSD3D(cfg.model, device="cpu")
    with torch.no_grad():
        model.vote_out.bias.copy_(torch.tensor([10.0, -10.0, 10.0]))
    pts, feats, mask = cloud(2)
    with torch.no_grad():
        ep = model(pts, feats, mask=mask)
    off = ep["vote_offset"]
    assert off[..., 0].max() == 3.0 and off[..., 1].min() == -3.0
    assert off[..., 2].max() == 2.0 and off.abs().max() <= 3.0


def test_top_scores_keeps_the_first_k_by_score():
    score = torch.tensor([[0.5, 0.9, 0.5, 0.1, 0.7, 0.5]])
    keep = torch.tensor([[True, True, True, True, False, True]])
    got = top_scores(keep, score, 3)
    # 0.9, then the 0.5s in slot order: slots 0 and 2; slot 5 is cut
    assert got.tolist() == [[True, True, True, False, False, False]]
    assert torch.equal(top_scores(keep, score, 0), keep)
    assert torch.equal(top_scores(keep, score, 6), keep)


def test_row_local_iou_holds_slivers_to_the_float64_iou():
    """The oriented NMS computes each row of the IoU in the row box's frame
    (ops/nms.py): on pairs of 3DSSD-like boxes (sides clamped at the 0.1 m
    size floor, 5-70 m out, overlapping) the op on the scene's coordinates
    leaves the exact IoU by more than the cell's 3e-4 on some pairs, the
    walk's IoU in the row's frame by under 1e-6 on all."""
    from portbench.reference import outdoor
    from tpu3dsad_torch.ops.boxes import box_corners, oriented_bev_iou
    from tpu3dsad_torch.ops.nms import nms_oriented

    rng = np.random.default_rng(0)
    M = 20000

    def boxes(c):
        size = np.maximum(2 * rng.normal(0, 0.8, (M, 3)), 0.1)
        head = rng.uniform(-np.pi, np.pi, M)
        return box_corners(*(torch.from_numpy(np.asarray(v, np.float32))
                             for v in (c, size, head)))

    ca = np.stack([rng.uniform(5, 70, M), rng.uniform(-35, 35, M),
                   rng.uniform(-2, 0, M)], -1)
    cb = ca + rng.normal(0, [1.0, 1.0, 0.3], (M, 3))
    corners = torch.stack([boxes(ca), boxes(cb)], 1)  # [M, 2, 8, 3]
    exact = outdoor.oriented_iou(corners[:, :1], corners[:, 1:])[:, 0, 0]
    score = torch.ones(M, 2)
    valid = torch.ones(M, 2, dtype=torch.bool)
    _, ious = recorded(lambda: nms_oriented(corners, score, valid, 0.1))
    gaps = {}
    for frame, iou in (("scene", oriented_bev_iou(corners, corners)),
                       ("row", ious[0])):
        iou = iou[:, 0, 1].double()
        pair = (iou > 0) | (exact > 0)
        gaps[frame] = (iou - exact).abs()[pair]
    assert int(pair.sum()) > 1000
    assert gaps["scene"].max() > 3e-4 and gaps["row"].max() < 1e-6


# ------------------------------------------------------------- the model


def served_pair(seed: int):
    """(the program's six fields, its recorded picks and walk inputs, the
    reference's serve) on one seeded batch."""
    config = small_config()
    cfg = port_config(config)
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg, device="cpu")
    assert isinstance(model, SSD3D)
    shapes = {n: tuple(v.shape) for n, v in model.state_dict().items()
              if v.is_floating_point()}
    assert list(shapes.items()) == list(
        reference.shapes(config["model"]).items())
    params = weights.draw(shapes, seed, "cpu")
    model.load_state_dict(params)
    pts, feats, mask = cloud(seed)
    with torch.no_grad():
        model.train()
        model(pts, feats, mask=mask, bn_momentum=0.0)
        model.eval()
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes,
                                       with_features=True)
    out = infer(pts, mask, feats)
    picks, ious = recorded(infer, pts, mask, feats)
    ref_params = reference.calibrate(params, config, pts, feats, mask, "fp32")
    ref = reference.serve(ref_params, config, pts, feats, mask, "fp32")
    return out, picks, ious, ref


@pytest.mark.parametrize("seed", [2400000017, 2**31 + 24])
def test_served_program_equals_the_plain_reference(seed):
    out, picks, ious, ref = served_pair(seed)
    assert [p.shape[1] for p in picks] == [512, 64, 64, 32, 32]
    assert pick_mismatches(picks, ref["picks"]) == (0, B * 704)
    fields = {k: ref[k] for k in out}
    assert compare.slot_mismatches(out, fields) == (0, B * 32)
    for k in ("center", "size", "heading", "obj_prob"):
        np.testing.assert_allclose(out[k].numpy(), fields[k].numpy(),
                                   rtol=0, atol=1e-5)
    assert torch.equal(out["keep"], ref["keep"])
    assert len(ious) == 1 and torch.equal(ious[0].double() > 0,
                                          ref["iou"] > 0)


def test_planted_dfps_in_place_of_ffps_is_seen():
    """The pick check tells F-FPS from D-FPS: the reference with D-FPS in
    F-FPS's place disagrees on a quarter or more of SA2's and SA3's F-FPS
    picks (the first picks, far apart in xyz, agree), and its share of all
    picks is above the cell's limit (1%)."""
    config = small_config()
    params = weights.draw(reference.shapes(config["model"]), 5, "cpu")
    pts, feats, mask = cloud(5)
    sound = reference.serve(params, config, pts, feats, mask, "fp32")
    saved = reference.ffps
    reference.ffps = lambda vec, m, part: reference.dfps(
        vec[..., :3].contiguous(), m, part)
    try:
        planted = reference.serve(params, config, pts, feats, mask, "fp32")
    finally:
        reference.ffps = saved
    for call in (1, 3):  # SA2's and SA3's F-FPS
        bad, total = pick_mismatches(planted["picks"][call:call + 1],
                                     sound["picks"][call:call + 1])
        assert bad > 0.25 * total
    assert compare.share([pick_mismatches(planted["picks"],
                                          sound["picks"])]) > 1.0


# ------------------------------------------------------------- entry points


def test_preset_builds_3dssd_through_the_one_factory():
    cfg = parse_cli(["preset=3dssd"])
    assert cfg.model.name == "ssd3d" and cfg.model.num_classes == 1
    assert cfg.eval.nms_iou == 0.1 and cfg.eval.use_oriented_nms
    assert cfg.model == ModelConfig(name="ssd3d", num_classes=1)
    # the published widths are the defaults; every other default is as
    # before
    assert Config().model.name == "detector"
    cfg = parse_cli(["preset=3dssd", *SMALL_ARGS])
    assert cfg.model.ssd3d_npoints == ((512,), (64,), (32, 32))
    model = build_detector(cfg, device="cpu")
    pts, feats, mask = cloud(3)
    out = serving.build_inference_fn(cfg, model, model.mean_sizes,
                                     with_features=True)(pts, mask, feats)
    assert set(out) == set(serving._EXPORT_KEYS)
    assert out["keep"].shape == (B, 32)
    assert (out["sem_cls"] == 0).all()
    assert ((out["obj_prob"] > 0) & (out["obj_prob"] < 1)).all()
    with pytest.raises(ValueError, match="feature"):
        model(pts, mask=mask)
    # mmdet3d's own NMS flavour, the axis-aligned BEV hulls, serves too
    bev = parse_cli(["preset=3dssd", *SMALL_ARGS,
                     "eval.use_oriented_nms=false", "eval.use_3d_nms=false"])
    out = serving.build_inference_fn(bev, model, model.mean_sizes,
                                     with_features=True)(pts, mask, feats)
    assert 0 < out["keep"].sum() <= B * 32


def test_eval_detector_runs_3dssd_on_a_kitti_split(tmp_path):
    from tpu3dsad_torch.data import synthetic_outdoor
    from tpu3dsad_torch.eval_detector import run_eval

    synthetic_outdoor.main([f"out={tmp_path}", "points=32768", "scenes=1",
                            "val_scenes=2"])
    cfg = parse_cli(["preset=3dssd", *SMALL_ARGS, f"data.root={tmp_path}",
                     "train.batch_size=2", "eval.ap_iou_threshs=(0.25,)",
                     f"train.ckpt_dir={tmp_path / 'ckpt'}"])
    out = run_eval(cfg, device="cpu")
    assert out["ckpt_step"] == 0 and out["val_loss"] is None
    assert 0.0 <= out["mAP@0.25"] <= 1.0


def test_export_holds_one_node_per_feature_fps_call(tmp_path):
    cfg = parse_cli(["preset=3dssd", *SMALL_ARGS, "data.num_points=1024",
                     "model.ssd3d_npoints=((256,),(32,),(16,16))",
                     "model.ssd3d_fps_ranges=((-1,),(-1,),(32,-1))"])
    model = build_detector(cfg, device="cpu")
    path = str(tmp_path / "m.pt2")
    manifest = serving.export_detector(cfg, model, model.mean_sizes, 1, path,
                                       with_features=True,
                                       source_dataset="kitti")
    assert manifest["feature_channels"] == 1
    program = serving.load(path)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert sum("tpu3dsad_torch.ffps" in t for t in targets) == 2
    assert sum("tpu3dsad_torch.fps" in t for t in targets) == 3
    pts, feats, mask = (t[:1, :1024] for t in cloud(4))
    with torch.no_grad():
        got = program.module()(pts, mask, feats)
    want = serving.build_inference_fn(cfg, model, model.mean_sizes,
                                      with_features=True)(pts, mask, feats)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_spans_of_a_forward():
    cfg = port_config(small_config())
    model = SSD3D(cfg.model, device="cpu")
    pts, feats, mask = cloud(6)
    trace.enable()
    with torch.no_grad():
        serving.build_inference_fn(cfg, model, model.mean_sizes,
                                   with_features=True)(pts, mask, feats)
    names = [r["name"] for r in trace.collect()]
    for name in ("ssd3d.sa1", "ssd3d.sa2", "ssd3d.sa3", "ssd3d.vote",
                 "ssd3d.cg", "ssd3d.head", "parse.decode", "parse.nms",
                 "parse.iou"):
        assert names.count(name) == 1, name
    assert names.count("sample.dfps") == 3
    assert names.count("sample.ffps") == 2


# ------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def kernel_against_plain(points, m, mask=None, plans=None):
    from tpu3dsad_torch.ops.cuda import ffps as cuda_ffps

    before = cuda_ffps.launches
    got = cuda_ffps.feature_fps(points, m, mask, plans=plans)
    with ops.use_impl("plain"):
        want = ops.feature_furthest_point_sample(points, m, mask=mask)
    assert cuda_ffps.launches == before + 1
    assert torch.equal(got, want)
    return got


@pytest.mark.card
@pytest.mark.parametrize("shape", [(16, 4096, 67, 512), (16, 512, 131, 256)],
                         ids=["sa2", "sa3"])
def test_ffps_kernel_equals_plain_at_the_cells_shapes(card, shape):
    b, n, d, m = shape
    g = torch.Generator(device=card).manual_seed(n)
    xyz = torch.rand(b, n, 3, generator=g, device=card) * 40
    feats = torch.relu(torch.randn(b, n, d - 3, generator=g, device=card))
    for _ in range(2):  # a wrong fence shows as a rare wrong pick
        kernel_against_plain(torch.cat([xyz, feats], -1), m)


RAGGED = {
    "ragged": (3, 1000, 5, 100, "none"),
    "masked": (2, 777, 67, 200, "tail"),
    "small": (2, 33, 131, 33, "none"),
    "ties": (2, 600, 4, 300, "grid"),
    "all-masked": (1, 64, 7, 8, "all"),
    "largest": (1, 6768, 67, 64, "none"),
}


@pytest.mark.card
@pytest.mark.parametrize("case", RAGGED, ids=list(RAGGED))
def test_ffps_kernel_equals_plain_on_ragged_shapes(card, case):
    from tpu3dsad_torch.ops.cuda import ffps as cuda_ffps

    b, n, d, m, kind = RAGGED[case]
    g = torch.Generator(device=card).manual_seed(n + d)
    x = (torch.randint(0, 3, (b, n, d), generator=g, device=card).float()
         if kind == "grid" else torch.randn(b, n, d, generator=g,
                                            device=card))
    mask = None
    if kind == "tail":
        mask = torch.arange(n, device=card)[None].expand(b, n) < n - 300
    elif kind == "all":
        mask = torch.zeros(b, n, dtype=torch.bool, device=card)
    kernel_against_plain(x, m, mask)
    assert cuda_ffps.last_plan.cluster <= cuda_ffps.MAX_CLUSTER


@pytest.mark.card
def test_ffps_kernel_over_xyz_equals_b1_and_every_plan(card):
    from tpu3dsad_torch.ops.cuda import ffps as cuda_ffps

    g = torch.Generator(device=card).manual_seed(7)
    xyz = torch.rand(4, 3000, 3, generator=g, device=card)
    want = ops.furthest_point_sample(xyz, 500)
    for plans in (None, [cuda_ffps.Plan(1, 512, 8)],
                  [cuda_ffps.Plan(3, 96, 16)],
                  [cuda_ffps.Plan(8, 384, 1)]):
        assert torch.equal(kernel_against_plain(xyz, 500, plans=plans),
                           want)
