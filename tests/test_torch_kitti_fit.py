"""The KITTI outdoor configuration on the port's served path: the fit of a
raw scan (data/kitti.py::fit_scene), the served fit of a KITTI artifact
(serving.prepare_scene_batch), the served program with oriented NMS held
to the benchmark's plain reference (portbench/reference/outdoor.py), and
the spans of the fit, the NMS IoU and the data-parallel all-reduce.

On the CPU, at a small size (raw scans of 8192 points, a budget of 1024,
toy widths, seeded weights):

  * fit_scene's rows are the file loader's (its crop, then the plain FPS
    of host_fps), bitwise, and device_fps takes fit_scene's picks;
  * prepare_scene_batch of a kitti manifest is fit_scene's fit as scene 0;
  * the served program (fit, forward, oriented NMS) equals the plain
    reference: the fitted rows equal, every served slot within the sweep
    cell's tolerances, keep equal;
  * the reference's oriented IoU (written from its definition) equals
    ops/boxes.py::oriented_bev_iou on random rotated boxes, and the KITTI
    cell's IoU check (the NMS walk's input recorded and held to it) passes
    the program's IoU and fails a planted axis-aligned or zero IoU;
  * the benchmark's frozen scan generator draws the program's scans;
  * the spans data.fit > fit.crop, fit.fps appear once a fit, parse.iou
    once a parse inside parse.nms, and train.allreduce once a step of a
    world-2 gloo data-parallel step (none at world 1); with the tracer off
    nothing is recorded.

On the card (`card` tests, skipped without one): the fit at 122880 points
equals the plain FPS's picks through B2, with its counters; B2's pruned
pass equals the plain FPS bitwise on the cell's scans (3 seeds), on a scan
in a sensor's ring order and on clouds with duplicate points and NaN
coordinates (where a valid point's coordinate is NaN, the unpruned
kernel's picks: the plain version takes the NaN in), and its engaged
counter equals tests/fps_model.py's count; the eval-kitti-b8 cell runs
through the harness correct. The fits of eight views of one batch on the
card, each on a side stream from the batch's ready point, equal each
scan's fit alone bitwise and count 7 shared ready points of 8 fits; their
outputs stay the caller's while the side streams fit the rest of the
batch; a write to the batch between fits takes a fresh ready point and is
seen; the crop's count is the fit's one host synchronisation. On the CPU,
the rule that decides when a fit shares a ready point.

This file imports no JAX, so on the card it runs alone:
    python -m pytest tests/test_torch_kitti_fit.py --noconftest -m card
"""

import dataclasses
import gc
import json
import subprocess
import sys
import weakref
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from portbench import weights  # noqa: E402
from portbench.harness import Context  # noqa: E402
from portbench.reference import compare, detector as reference  # noqa: E402
from portbench.reference import outdoor as reference_outdoor  # noqa: E402
from portbench.traffic import outdoor as traffic  # noqa: E402
from tpu3dsad_torch import ops, serving, train_lib  # noqa: E402
from tpu3dsad_torch.config import Config  # noqa: E402
from tpu3dsad_torch.data import kitti, synthetic_outdoor  # noqa: E402
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector  # noqa: E402
from tpu3dsad_torch.ops.boxes import box_corners, oriented_bev_iou  # noqa: E402
from tpu3dsad_torch.utils import trace  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RAW, BUDGET = 8192, 1024
TOY = dict(sa_npoints=[128, 64, 32, 16], sa_nsamples=[8, 8, 4, 4],
           sa_channels=[[8, 8, 16], [16, 16, 32], [16, 16, 32],
                        [16, 16, 32]],
           fp_channels=[[32, 32], [32, 32]], seed_feat_dim=32,
           num_proposals=16, cluster_nsample=4)


def raw_scan(seed: int, points: int = RAW) -> np.ndarray:
    """A raw outdoor scan [points, 4] (at most 3 objects, so that they fit
    in a small scan)."""
    return synthetic_outdoor.outdoor_scene(np.random.default_rng(seed),
                                           points, max_objects=3)[0]


def port_config(config: dict):
    """The program's Config of a configuration file's sections, as the
    harness makes it."""
    return Context.port_config(SimpleNamespace(config=config))


def toy_config() -> dict:
    cfg = json.loads((REPO / "portbench" / "configs"
                      / "sadet-kitti-16k.json").read_text())
    cfg["model"].update(TOY)
    cfg["data"]["num_points"] = BUDGET
    return cfg


@pytest.fixture(autouse=True)
def tracer_off():
    trace.enable(False)
    trace.collect()
    yield
    trace.enable(False)
    trace.collect()


# ------------------------------------------------------------- the fit


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_scene_equals_the_loaders_crop_and_fps(seed):
    pc = raw_scan(seed)
    crop = kitti.range_crop(pc)
    assert len(crop) > BUDGET
    picks = kitti.host_fps(pc[crop][:, :3], BUDGET)
    fit = kitti.fit_scene(pc, BUDGET, "cpu")
    np.testing.assert_array_equal(fit.rows.numpy(), crop[picks])
    np.testing.assert_array_equal(fit.picks.numpy(), picks)
    np.testing.assert_array_equal(fit.points.numpy(),
                                  pc[crop[picks], :3])
    assert fit.mask.all() and fit.points.shape == (BUDGET, 3)
    np.testing.assert_array_equal(
        kitti.device_fps(pc[crop], BUDGET, device="cpu"), picks)


def test_fit_scene_pads_a_scan_the_crop_leaves_short():
    pc = raw_scan(3)
    pc[200:, 0] = -5.0  # behind the sensor: cropped
    fit = kitti.fit_scene(pc, BUDGET, "cpu")
    crop = kitti.range_crop(pc)
    k = len(crop)
    assert k < BUDGET and fit.picks is None
    np.testing.assert_array_equal(fit.rows.numpy(), crop)
    np.testing.assert_array_equal(fit.points[:k].numpy(), pc[crop, :3])
    assert not fit.points[k:].any() and fit.mask.sum() == k


@pytest.mark.parametrize("with_features", [False, True])
def test_prepare_scene_batch_of_a_kitti_scan_is_fit_scene(with_features):
    pc = raw_scan(4)
    manifest = {"batch_size": 2, "num_points": BUDGET,
                "with_features": with_features, "source_dataset": "kitti"}
    args = serving.prepare_scene_batch(pc, manifest, device="cpu")
    fit = kitti.fit_scene(pc, BUDGET, "cpu")
    assert len(args) == 2 + with_features
    assert torch.equal(args[0][0], fit.points)
    assert torch.equal(args[1][0], fit.mask)
    assert not args[0][1].any() and not args[1][1].any()
    if with_features:  # a scan of xyz + intensity has no colour columns
        assert not args[2].any()


@pytest.mark.parametrize("case", ["same", "bumped", "other", "no view",
                                  "collected", "other stream"])
def test_ready_point_is_shared_only_by_views_of_one_unchanged_base(case):
    """fit_scene's rule on the card, on CPU tensors: a fit waits on the
    ready point that the first fit of a view of the same base recorded
    only while that base is alive, at the same version, and the caller's
    stream is the same; every other fit takes a fresh one."""
    raw = torch.zeros(4, 16, 4)
    slot = kitti.Ready(weakref.ref(raw), raw._version, "caller", None)
    base, stream = raw[1]._base, "caller"
    if case == "bumped":
        raw[2].add_(1.0)  # a write through another view
    elif case == "other":
        base = raw.clone()
    elif case == "no view":
        base = raw.clone()._base  # a tensor that is no view has none
        assert base is None
    elif case == "collected":
        gone = torch.zeros(4, 16, 4)
        slot = kitti.Ready(weakref.ref(gone), gone._version, "caller", None)
        del gone
        gc.collect()
        assert slot.base() is None
    elif case == "other stream":
        stream = "another"
    version = None if base is None else base._version
    assert kitti.shares_ready_point(slot, base, version, stream) == (
        case == "same")
    assert not kitti.shares_ready_point(None, base, version, stream)


def test_frozen_scan_generator_draws_the_programs_scans():
    for seed in (5, 6):
        got = traffic.outdoor_scene(np.random.default_rng(seed), 32768)
        want = synthetic_outdoor.outdoor_scene(np.random.default_rng(seed),
                                               32768)[0]
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ served program


def test_served_outdoor_program_equals_the_plain_reference():
    config = toy_config()
    cfg = port_config(config)
    train_lib.apply_runtime_config(cfg)
    model = SizeAdaptiveDetector(cfg.model, traffic.KITTI_MEAN_SIZES,
                                 device="cpu")
    shapes = {n: tuple(v.shape) for n, v in model.state_dict().items()
              if v.is_floating_point()}
    params = weights.draw(shapes, 2200000017, "cpu")
    model.load_state_dict(params)
    scans = np.stack([raw_scan(s) for s in (7, 8)])

    fits = [kitti.fit_scene(s, BUDGET, "cpu") for s in scans]
    points = torch.stack([f.points for f in fits])
    mask = torch.stack([f.mask for f in fits])
    with torch.no_grad():
        model.train()
        model(points, mask=mask, bn_momentum=0.0)
        model.eval()
    out = serving.build_inference_fn(cfg, model, model.mean_sizes)(points,
                                                                   mask)
    out = {k: v.cpu() for k, v in out.items()}

    ref_points, ref_mask, ref_rows = reference_outdoor.fit(
        torch.from_numpy(scans), BUDGET)
    for f, rows in zip(fits, ref_rows):
        assert torch.equal(f.rows, rows)
    assert torch.equal(ref_points, points) and torch.equal(ref_mask, mask)
    sizes = traffic.KITTI_MEAN_SIZES
    ref_params = reference.calibrate(params, config, sizes, ref_points,
                                     ref_mask, "fp32")
    ref = reference_outdoor.serve(ref_params, config, sizes, ref_points,
                                  ref_mask, "fp32")
    bad, total = compare.slot_mismatches(out, ref)
    assert (bad, total) == (0, 2 * TOY["num_proposals"])
    assert torch.equal(out["keep"], ref["keep"]) and ref["keep"].any()


def random_boxes(seed: int, K: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(corners [1, K, 8, 3], sizes [1, K, 3]) of random rotated boxes."""
    g = torch.Generator().manual_seed(seed)
    center = torch.rand(1, K, 3, generator=g) * torch.tensor([6.0, 6.0, 1.0])
    size = torch.rand(1, K, 3, generator=g) * 3.0 + 0.2
    heading = (torch.rand(1, K, generator=g) * 2 - 1) * np.pi
    # a box repeated, one inside another, one turned by a right angle
    center[0, 1], size[0, 1], heading[0, 1] = center[0, 0], size[0, 0], \
        heading[0, 0]
    center[0, 2], size[0, 2], heading[0, 2] = center[0, 0], \
        0.5 * size[0, 0], heading[0, 0]
    center[0, 3], size[0, 3], heading[0, 3] = center[0, 0], size[0, 0], \
        heading[0, 0] + np.pi / 2
    return box_corners(center, size, heading), size


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_oriented_iou_equals_the_programs(seed):
    c, _ = random_boxes(seed, 24)
    got = reference_outdoor.oriented_iou(c, c)
    want = oriented_bev_iou(c, c).double()
    assert (want > 0).float().mean() > 0.1  # overlaps are exercised
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert got[0, 0, 1] == pytest.approx(1.0)
    assert got[0, 0, 2] == pytest.approx(0.125, abs=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_iou_check_holds_the_walks_input_to_the_plain_iou(seed):
    from portbench.control_outdoor import aabb_iou, no_iou
    from portbench.drivers.outdoor import iou_share, walk_inputs
    from tpu3dsad_torch.ops.nms import nms_oriented

    c, size = random_boxes(seed, 24)
    scores = torch.rand(1, 24, generator=torch.Generator().manual_seed(seed))
    valid = torch.ones(1, 24, dtype=torch.bool)
    seen = walk_inputs(nms_oriented, c, scores, valid, 0.25)
    assert len(seen) == 1
    ref = reference_outdoor.oriented_iou(c, c)
    bad, pairs = reference_outdoor.iou_mismatches(seen[0], ref, size)
    assert bad == 0 and pairs > 24
    for planted in (aabb_iou, no_iou):  # each fails the cell's limit
        share = iou_share([reference_outdoor.iou_mismatches(
            planted(c, c), ref, size)], [True])
        assert share > 1.0
    # a pair with a footprint narrower than MIN_SIDE is not compared
    off = ref.clone()
    off[0, 0, 1] -= 0.1  # box 1 repeats box 0
    assert reference_outdoor.iou_mismatches(off, ref, size) == (1, pairs)
    thin = size.clone()
    thin[0, 1, 1] = 0.5 * reference_outdoor.MIN_SIDE
    assert reference_outdoor.iou_mismatches(off, ref, thin)[0] == 0
    # no overlap on either side agrees; a call that ran no walk is NaN
    apart = torch.zeros(1, 4, 4)
    assert iou_share([reference_outdoor.iou_mismatches(
        apart, apart, torch.ones(1, 4, 3))], [True]) == 0.0
    assert np.isnan(iou_share([(0, 0)], [False]))


# ------------------------------------------------------------- spans


def test_fit_spans_once_a_fit_and_nothing_when_off():
    pc = raw_scan(9)
    kitti.fit_scene(pc, BUDGET, "cpu")
    assert trace.collect() == []
    trace.enable()
    kitti.fit_scene(pc, BUDGET, "cpu")
    records = trace.collect()
    assert [(r["name"], r["parent"]) for r in records] == [
        ("data.fit", None), ("fit.crop", "data.fit"),
        ("fit.fps", "data.fit")]


@pytest.mark.parametrize("oriented", [False, True])
def test_parse_iou_span_inside_parse_nms(oriented):
    config = toy_config()
    config["eval"]["use_oriented_nms"] = oriented
    cfg = port_config(config)
    model = SizeAdaptiveDetector(cfg.model, traffic.KITTI_MEAN_SIZES,
                                 device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    fit = kitti.fit_scene(raw_scan(10), BUDGET, "cpu")
    infer = serving.build_inference_fn(cfg, model, model.mean_sizes)
    trace.enable()
    infer(fit.points[None], fit.mask[None])
    records = trace.collect()
    names = [(r["name"], r["parent"]) for r in records]
    assert names.count(("parse.iou", "parse.nms")) == 1
    assert names.index(("parse.iou", "parse.nms")) == \
        names.index(("parse.nms", "serve.program")) + 1


def dp_step_spans(rank: int, world: int, tracer: bool) -> list:
    """A rank of a data-parallel step of the toy detector on the CPU: the
    (name, parent) of every span it records."""
    from tpu3dsad_torch.data.device_pipeline import synthetic_detection_batch
    from tpu3dsad_torch.parallel import make_mesh, shard_batch

    cfg = dataclasses.replace(port_config(toy_config()),
                              data=dataclasses.replace(
                                  Config().data, num_points=256,
                                  max_boxes=8))
    model = SizeAdaptiveDetector(cfg.model, device="cpu",
                                 generator=torch.Generator().manual_seed(3))
    mesh = make_mesh((-1,), ("data",))
    opt = train_lib.make_optimizer(cfg.train, 1 << 20, model.parameters(),
                                   train_lib.data_axis(mesh))
    step = train_lib.make_detector_steps(model, opt, cfg)
    batch = synthetic_detection_batch(
        torch.Generator().manual_seed(1), 4, 256, cfg.model.num_classes, 8,
        vote_candidates=cfg.data.vote_candidates)
    trace.enable(tracer)
    step(shard_batch(batch, mesh), torch.Generator().manual_seed(5), 0.5)
    records = trace.collect()
    trace.enable(False)
    return [(r["name"], r["parent"]) for r in records]


def test_dp_step_records_one_allreduce_span():
    from tpu3dsad_torch.parallel import launch

    import test_torch_kitti_fit as me

    ranks = launch.spawn(me.dp_step_spans, 2, backend="gloo", args=(True,))
    for names in ranks:
        assert names.count(("train.allreduce", "train.optimizer")) == 1
    assert ("train.allreduce", "train.optimizer") not in dp_step_spans(
        0, 1, True)
    assert dp_step_spans(0, 1, False) == []


# ------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.card
def test_fit_on_the_card_equals_plain_fps_at_122880(card):
    from tpu3dsad_torch.ops.cuda import fps as cuda_fps

    scan = traffic.outdoor_scene(np.random.default_rng(20), 122880)
    launches, points = cuda_fps.flat_launches, cuda_fps.flat_points
    fit = kitti.fit_scene(scan, 16384, card)
    crop = kitti.range_crop(scan)
    padded = -(-len(crop) // 4096) * 4096
    assert len(crop) > 65536
    assert cuda_fps.flat_launches == launches + 1
    assert cuda_fps.flat_points == points + padded
    with ops.use_impl("plain"):
        plain = kitti.fit_scene(scan, 16384, card)
    assert torch.equal(fit.rows, plain.rows)
    assert torch.equal(fit.points, plain.points)
    np.testing.assert_array_equal(
        kitti.device_fps(scan[crop], 16384, device=card),
        fit.picks.cpu().numpy())


def bucketed(xyz: np.ndarray, card) -> tuple[torch.Tensor, torch.Tensor]:
    """A cropped cloud [n, 3] padded to the fit's 4096 bucket on the card,
    as fit_fps gives it to B2: ([1, P, 3], mask [1, P])."""
    n = len(xyz)
    cloud = torch.zeros(1, -(-n // 4096) * 4096, 3, device=card)
    cloud[0, :n] = torch.from_numpy(np.ascontiguousarray(xyz[:, :3],
                                                         np.float32))
    return cloud, (torch.arange(cloud.shape[1], device=card) < n)[None]


def b2_against(cloud, mask, m, want=None):
    """B2 (pruned) on one cloud, three times, bitwise `want` (the plain
    FPS's picks where None) and the unpruned kernel's at the same plan."""
    from tpu3dsad_torch.ops.cuda import fps as cuda_fps
    from tpu3dsad_torch.ops.plain import furthest_point_sample as plain_fps

    sms = torch.cuda.get_device_properties(cloud.device).multi_processor_count
    first = cuda_fps.plan(1, cloud.shape[1], sms)[0]
    assert first.points == cuda_fps.PRUNED_POINTS
    unpruned = cuda_fps.fps_batched(cloud, m, mask, [first])
    if want is None:
        want = plain_fps(cloud, m, mask=mask)
        assert torch.equal(unpruned, want)
    for _ in range(3):  # a missed fence shows as a rare wrong pick
        assert torch.equal(cuda_fps.fps_flat(cloud, m, mask), want)
    return want


@pytest.mark.card
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_pruned_b2_equals_plain_fps_on_the_cells_scans(card, seed):
    scan = traffic.outdoor_scene(np.random.default_rng(seed), 122880)
    crop = scan[kitti.range_crop(scan)]
    assert len(crop) > 65536
    b2_against(*bucketed(crop, card), 16384)


@pytest.mark.card
def test_pruned_b2_equals_plain_fps_on_a_scan_in_ring_order(card):
    """The scan's points in a spinning sensor's order (64 elevation rings,
    each by azimuth) where the generator's are random: the deal reorders
    either."""
    scan = traffic.outdoor_scene(np.random.default_rng(24), 122880)
    crop = scan[kitti.range_crop(scan)]
    x, y, z = crop[:, 0], crop[:, 1], crop[:, 2]
    ring = np.digitize(np.arctan2(z, np.hypot(x, y)), np.linspace(
        -0.45, 0.1, 63))
    crop = crop[np.lexsort((np.arctan2(y, x), ring))]
    b2_against(*bucketed(crop, card), 16384)


@pytest.mark.card
def test_pruned_b2_on_duplicates_and_nan_coordinates(card):
    """Exact duplicates (a grid repeated 10 times: ties across slabs); NaN
    coordinates on masked points (held to plain); NaN coordinates on valid
    points (held to the unpruned kernel: its fminf keeps such a point's
    distance, the plain version's torch.minimum does not)."""
    gen = torch.Generator(device=card).manual_seed(25)
    grid = torch.randint(-6, 7, (1, 8192, 3), device=card, generator=gen)
    dup = grid.float().repeat(1, 10, 1).contiguous()
    b2_against(dup, None, 2048)
    pts = torch.empty(1, 100000, 3, device=card).uniform_(-30, 30,
                                                          generator=gen)
    mask = torch.rand(1, 100000, device=card, generator=gen) < 0.9
    mask[0, 0] = True  # the first pick, index 0, is a valid point
    pts[~mask] = float("nan")
    b2_against(pts, mask, 2048)
    hit = torch.rand(1, 100000, 3, device=card, generator=gen) < 0.001
    pts = torch.where(hit, float("nan"), pts.nan_to_num(0.0))
    from tpu3dsad_torch.ops.cuda import fps as cuda_fps

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    first = cuda_fps.plan(1, 100000, sms)[0]
    b2_against(pts, mask, 2048, cuda_fps.fps_batched(pts, 2048, mask,
                                                     [first]))


@pytest.mark.card
def test_pruned_b2_engaged_counter_equals_the_model(card):
    """On a small cloud at a forced plan of 4 CTAs x 4 warps: the card's
    pre-pass equals the numpy deal of the plain Z-order keys, and the
    kernel's picks and engaged warp-rounds equal tests/fps_model.py's on
    that order."""
    from fps_model import model_fps, slabs
    from tpu3dsad_torch.ops.cuda import fps as cuda_fps
    from tpu3dsad_torch.ops.sorted import z_keys

    scan = traffic.outdoor_scene(np.random.default_rng(26), 8192,
                                 max_objects=3)
    xyz = np.ascontiguousarray(scan[kitti.range_crop(scan), :3])
    mask = np.random.default_rng(27).random(len(xyz)) < 0.95
    cloud = torch.from_numpy(xyz)[None].to(card)
    valid = torch.from_numpy(mask)[None].to(card)
    p = cuda_fps.Plan(4, 128, 16)
    order = cuda_fps.slab_order(cloud, valid).cpu().numpy()
    codes, _ = z_keys(torch.from_numpy(xyz)[None],
                      torch.from_numpy(xyz[:1])[None],
                      torch.from_numpy(mask)[None])
    np.testing.assert_array_equal(order, slabs(codes[0].numpy()))
    engaged = torch.zeros(1, dtype=torch.int64, device=card)
    got = cuda_fps.fps_flat(cloud, 256, valid, [p], engaged)
    want, count = model_fps(xyz, 256, mask, p, order)
    np.testing.assert_array_equal(got[0].cpu().numpy(), want)
    assert engaged.item() == count
    assert 0 < count < 255 * 16


CELL_SEEDS = range(30, 38)


@pytest.fixture(scope="module")
def cell_batch():
    """Eight of the KITTI cell's raw scans as one batch tensor on the card
    [8, 122880, 4], and each one's fit alone (a scan that is no view, the
    card synchronised after each fit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    raw = torch.from_numpy(np.stack([traffic.outdoor_scene(
        np.random.default_rng(s), 122880) for s in CELL_SEEDS])).cuda()
    return raw, fits_alone(raw)


def fits_alone(raw: torch.Tensor) -> list:
    out = []
    for b in range(raw.shape[0]):
        out.append(kitti.fit_scene(raw[b].clone(), 16384, raw.device))
        torch.cuda.synchronize()
    return out


def assert_same_fits(got: list, want: list) -> None:
    """rows, picks, points and mask bitwise."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.picks is not None and torch.equal(g.picks, w.picks)
        assert torch.equal(g.rows, w.rows) and torch.equal(g.points, w.points)
        assert torch.equal(g.mask, w.mask)


@pytest.mark.card
def test_fits_of_one_batch_share_its_ready_point_and_equal_each_alone(
        cell_batch):
    raw, want = cell_batch
    fits, shared = kitti.fits, kitti.fits_shared
    got = [kitti.fit_scene(raw[b], 16384, raw.device) for b in range(8)]
    assert (kitti.fits - fits, kitti.fits_shared - shared) == (8, 7)
    assert_same_fits(got, want)


@pytest.mark.card
def test_fit_outputs_outlive_the_side_streams_next_fits(cell_batch):
    """Batches that reuse the allocator's blocks: the caller reads each
    half's fits behind a long wait on its stream and frees them, while the
    other half of the batch (the same ready point) is fitted on the same
    side streams; without record_stream those fits would take the freed
    blocks and write them before the caller read them."""
    raw, want = cell_batch
    kitti.fit_scene(raw[0], 16384, raw.device)  # the pool is made
    k = len(kitti._sides[raw.device][0])
    for rep in range(3):
        order = [(rep + j) % 8 for j in range(2 * k)]
        batch = raw[order]
        read = []
        for half in (range(k), range(k, 2 * k)):
            got = [kitti.fit_scene(batch[j], 16384, raw.device)
                   for j in half]
            torch.cuda._sleep(200_000_000)  # ~0.1 s at the card's clock
            read += [kitti.Fit(*(t.clone() for t in f)) for f in got]
            del got
        torch.cuda.synchronize()
        assert_same_fits(read, [want[b] for b in order])


@pytest.mark.card
def test_a_write_to_the_batch_between_fits_takes_a_fresh_ready_point(
        cell_batch):
    raw, want = cell_batch
    batch = raw[:3].clone()
    fits, shared = kitti.fits, kitti.fits_shared
    first = kitti.fit_scene(batch[0], 16384, raw.device)
    torch.cuda._sleep(200_000_000)  # the write lands late on the stream
    batch[1].copy_(raw[5])
    second = kitti.fit_scene(batch[1], 16384, raw.device)
    assert kitti.fits_shared == shared
    third = kitti.fit_scene(batch[2], 16384, raw.device)
    assert (kitti.fits - fits, kitti.fits_shared - shared) == (3, 1)
    assert_same_fits([first, second, third], [want[0], want[5], want[2]])


@pytest.mark.card
def test_the_fit_synchronises_the_host_only_at_the_crops_read_back(
        cell_batch, monkeypatch):
    raw, want = cell_batch
    kitti.fit_scene(raw[0], 16384, raw.device)  # the library, constants, pool
    batch = raw.clone()
    torch.cuda.synchronize()
    nonzero, crops = torch.Tensor.nonzero, []

    def read_back(self, *args, **kwargs):
        crops.append(self.shape)
        torch.cuda.set_sync_debug_mode(0)
        try:
            return nonzero(self, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(torch.Tensor, "nonzero", read_back)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [kitti.fit_scene(batch[b], 16384, raw.device)
               for b in range(8)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(crops) == 8
    assert_same_fits(got, want)


def run_bench(root: Path, cell: str, seconds: int, device: str) -> dict:
    proc = subprocess.run(
        [sys.executable, str(REPO / "portbench" / "tests" / "launch.py"),
         str(root), str(REPO), "", device, "--workload", cell, "--seed",
         "3300000123", "--seconds", str(seconds), "--trace", "0"],
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.card
def test_kitti_cell_runs_correct_on_the_card(card):
    line = run_bench(REPO, "eval-kitti-b8", 3, "cuda")
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["serve_scenes_per_s"]["value"] > 0
