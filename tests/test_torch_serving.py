"""The serving slice of the PyTorch port held against the JAX package on the
CPU (tpu3dsad/serving.py, tpu3dsad/utils/dump.py, demo.py), at the small
config of tests/e2e/test_serving.py with the same (bridged) weights:

  * the exported and reloaded program equals the port's eager path
    bitwise, and the JAX package's build_inference_fn as
    tests/test_torch_detector.py holds the served outputs: keep and
    sem_cls equal, the floats at rtol 1e-4, atol 1e-5 (fp32 matmuls summed
    in another order);
  * the manifest carries the reference's keys; the export / run CLI, the
    features calling convention and ScanNet's colour scaling round-trip;
  * prepare_scene_batch's numpy, the PLY / OBJ writers' bytes and the
    demo's files equal the reference's;
  * the exported graph holds one custom-op node per FPS and ball-query
    call and one for the NMS walk, and the ops pass torch.library.opcheck;
  * a train step after serving and after an export in one process (the
    host-constant cache holds no inference or fake tensor).
"""

import filecmp
import json
import os
import subprocess
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

import tpu3dsad.serving as jserving
import tpu3dsad.utils.dump as jdump
from tpu3dsad.config import parse_cli as jparse
from tpu3dsad.data.synthetic import class_mean_sizes, detection_batch
from tpu3dsad.models.detector import SizeAdaptiveDetector as JDetector
from tpu3dsad_torch import demo, ops, serving, train_lib
from tpu3dsad_torch.config import Config, parse_cli
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.ops import boxes as tboxes
from tpu3dsad_torch.ops import library
from tpu3dsad_torch.ops import sorted as tsorted
from tpu3dsad_torch.ops.cuda import ball_query as cuda_bq
from tpu3dsad_torch.ops.cuda import bn_relu as cuda_bn_relu
from tpu3dsad_torch.ops.cuda import fps as cuda_fps
from tpu3dsad_torch.ops.cuda import nms as cuda_nms
from tpu3dsad_torch.ops.cuda import scatter as cuda_scatter
from tpu3dsad_torch.utils import constants, dump
from tpu3dsad_torch.utils.bridge import load_flax_variables

from test_torch_nn import randomize

RTOL, ATOL = 1e-4, 1e-5
# tests/e2e/test_serving.py:15-23
_OVERRIDES = [
    "model.name=detector", "data.name=synthetic", "data.num_points=512",
    "data.max_boxes=8", "model.num_classes=4",
    "model.sa_npoints=(128,64,32,16)", "model.sa_nsamples=(8,8,4,4)",
    "model.sa_channels=((16,16),(16,32),(16,32),(16,32))",
    "model.fp_channels=((32,32),(32,32))", "model.seed_feat_dim=32",
    "model.num_proposals=16", "model.cluster_nsample=4",
    "train.batch_size=2",
]
COLOR = ["data.use_color=true"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(args, seed):
    """(reference cfg, port cfg, flax variables, port model, mean sizes):
    the small detector of `args` with randomized weights, bridged."""
    jcfg, tcfg = jparse(args), parse_cli(args)
    ms = class_mean_sizes(jcfg.model.num_classes)
    jm = JDetector(jcfg.model, mean_sizes=tuple(map(tuple, ms)))
    n = jcfg.data.num_points
    feats = jnp.zeros((1, n, 3)) if jcfg.data.use_color else None
    var = randomize(jax.jit(lambda k: jm.init(
        k, jnp.zeros((1, n, 3)), feats, train=False))(jax.random.key(0)),
        seed=seed)
    tm = SizeAdaptiveDetector(tcfg.model, ms, device="cpu",
                              in_features=3 if tcfg.data.use_color else 0)
    load_flax_variables(tm, var)
    return jcfg, tcfg, var, tm, ms


def _port_model(args, seed):
    """(port cfg, port model, mean sizes): the small detector of `args`
    with weights drawn from `seed`, where no JAX side is compared."""
    cfg = parse_cli(args)
    ms = class_mean_sizes(cfg.model.num_classes)
    model = SizeAdaptiveDetector(cfg.model, ms, device="cpu",
                                 in_features=3 if cfg.data.use_color else 0,
                                 generator=torch.Generator().manual_seed(seed))
    return cfg, model, ms


def _scene(rng, b=2, n=512, colors=False):
    """[points, mask(, colours)]: scenes in a 1 m cube, where proposals
    overlap, the last a quarter padding."""
    pts = rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[-1, n * 3 // 4:] = False  # a padded tail
    args = [pts, mask]
    if colors:
        args.append(rng.random((b, n, 3)).astype(np.float32))
    return args


def _equal(got, want):
    assert set(got) == set(want) == set(serving._EXPORT_KEYS)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _near_reference(got, jout):
    """The port's served outputs against the JAX package's."""
    assert set(got) == set(jout)
    for k in ("keep", "sem_cls"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    for k in ("center", "size", "heading", "obj_prob"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jout[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The small detector with and without colour, each exported by the
    port at B = 2 and reloaded, beside the JAX package's export of the same
    weights: {name: (pair, port manifest, loaded program, JAX manifest,
    JAX Exported)}. The colour artifact names scannet as its source."""
    root = tmp_path_factory.mktemp("exported")
    out = {}
    # weights under which NMS suppresses some proposals and keeps some
    for name, args, seed in (("points", _OVERRIDES, 8),
                             ("colour", _OVERRIDES + COLOR, 9)):
        jcfg, tcfg, var, tm, ms = _pair(args, seed)
        kw = dict(with_features=jcfg.data.use_color,
                  source_dataset="scannet" if jcfg.data.use_color else "")
        path, jpath = str(root / f"{name}.pt2"), str(root / f"{name}.bin")
        manifest = serving.export_detector(tcfg, tm, ms, 2, path, **kw)
        jmanifest = jserving.export_detector(jcfg, var, ms, 2, jpath, **kw)
        out[name] = ((jcfg, tcfg, var, tm, ms), path, manifest,
                     serving.load(path), jmanifest, jserving.load(jpath))
    return out


@pytest.mark.parametrize("name", ["points", "colour"])
def test_export_reproduces_live_pipeline_and_reference(exported, name):
    """The reloaded program is bitwise the eager build_inference_fn, and
    both are the JAX package's program (its live jit and its artifact are
    bitwise equal, tests/e2e/test_serving.py)."""
    (jcfg, tcfg, var, tm, ms), path, manifest, program, jman, jexp = \
        exported[name]
    colors = tcfg.data.use_color
    args = _scene(np.random.default_rng(0), colors=colors)
    live = serving.build_inference_fn(tcfg, tm, ms, with_features=colors)(
        *map(_t, args))
    with torch.no_grad():
        got = program.module()(*map(_t, args))
    _equal(got, live)
    _near_reference(got, jexp.call(*map(jnp.asarray, args)))
    keep = got["keep"].numpy()
    assert 0 < keep.sum() < keep.size  # NMS suppressed some, kept some

    assert manifest["num_points"] == 512 and manifest["bytes"] > 0
    assert manifest["bytes"] == os.path.getsize(path)
    with open(path + ".json") as f:
        assert json.load(f) == manifest
    assert set(manifest) == set(jman)
    for key in ("batch_size", "num_points", "num_classes", "outputs",
                "with_features", "source_dataset"):
        assert manifest[key] == jman[key], key
    assert manifest["platforms"] == ["cpu"]


def test_exported_graph_holds_one_node_per_kernel_call(exported):
    """5 FPS (SA1-4, the proposal) and 7 ball-query (SA1-4, the radius
    bank's 3) op nodes; no plain FPS loop or plain ball query unrolled."""
    program = exported["points"][3]
    calls = Counter(str(node.target) for node in program.graph.nodes
                    if node.op == "call_function")
    assert calls["tpu3dsad_torch.fps.default"] == 5
    assert calls["tpu3dsad_torch.ball_query.default"] == 7
    assert calls["tpu3dsad_torch.morton_codes.default"] == 0
    # FP1 and FP2's three_nn distance products, pinned to fp32 in the graph
    assert calls["tpu3dsad_torch.fp32_cross.default"] == 2
    assert calls["aten.bmm.default"] == 0
    assert calls["aten.topk.default"] == 0  # the plain ball query's
    # the plain FPS takes one argmax a pick (15 for the proposal's 16);
    # the decode's own argmaxes are a few
    assert calls["aten.argmax.default"] < 15


def test_exported_graph_holds_one_bn_relu_node_a_layer(exported):
    """Each BatchNorm layer's eval-mode BatchNorm and ReLU is one
    tpu3dsad_torch.bn_relu node (26 layers in the small detector: two a
    level): none of the chain's ops is in the graph."""
    (_, _, _, tm, _), _, _, program, *_ = exported["points"]
    layers = sum(type(m).__name__ == "MaskedBatchNorm" for m in tm.modules())
    calls = Counter(str(node.target) for node in program.graph.nodes
                    if node.op == "call_function")
    assert calls["tpu3dsad_torch.bn_relu.default"] == layers == 26
    for chained in ("aten.rsqrt.default", "aten.relu.default"):
        assert calls[chained] == 0, chained


def test_exported_graph_holds_one_walk_node(exported):
    """The NMS walk is one tpu3dsad_torch.greedy_suppress node: no step of
    the plain loop (its argsort, eye, per-step copies and ORs, scatter)
    is unrolled into the graph."""
    program = exported["points"][3]
    calls = Counter(str(node.target) for node in program.graph.nodes
                    if node.op == "call_function")
    assert calls["tpu3dsad_torch.greedy_suppress.default"] == 1
    for unrolled in ("aten.argsort.stable", "aten.eye.default",
                     "aten.copy_.default", "aten.__ior__.Tensor",
                     "aten.bitwise_or.Tensor", "aten.scatter_.src"):
        assert calls[unrolled] == 0, unrolled


def test_serving_cli_roundtrip(tmp_path, capsys):
    """ckpt= ... out= exports a port checkpoint (and refuses a directory
    with none); run= serves a raw scene, detection for detection the eager
    path on prepare_scene_batch's tensors."""
    args = _OVERRIDES + ["device=cpu"]
    with pytest.raises(SystemExit, match="no checkpoint found"):
        serving.main([f"ckpt={tmp_path / 'none'}",
                      f"out={tmp_path / 'x.pt2'}", *args])
    tcfg, tm, ms = _port_model(_OVERRIDES, 9)
    opt = train_lib.make_optimizer(tcfg.train, 10, tm.parameters())
    ckpt = str(tmp_path / "ckpt")
    train_lib.save_checkpoint(ckpt, tm, opt, 5)
    out = str(tmp_path / "model.pt2")
    capsys.readouterr()
    serving.main([f"ckpt={ckpt}", f"out={out}", *args])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ckpt_step"] == 5 and report["batch_size"] == 2
    assert report["source_dataset"] == "synthetic"

    rng = np.random.default_rng(1)
    for points in (800, 300):  # subsampled; padded
        scene = tmp_path / f"scene{points}.npy"
        raw = rng.uniform(-3, 3, (points, 3)).astype(np.float32)
        np.save(scene, raw)
        dst = tmp_path / f"dets{points}.json"
        serving.main([f"run={out}", f"scene={scene}", f"out={dst}",
                      "device=cpu"])
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        with open(dst) as f:
            assert json.load(f) == printed
        want = serving.build_inference_fn(tcfg, tm, ms)(
            *serving.prepare_scene_batch(raw, report, device="cpu"))
        dets = printed["detections"]
        assert dets == serving.detections(want) and dets
        for d in dets:
            assert set(d) == {"center", "size", "heading", "score", "class"}
    with pytest.raises(SystemExit, match="exported for"):
        serving.main([f"run={out}", f"scene={scene}", "device=meta"])


def test_run_cli_normalizes_scannet_colors(exported, tmp_path, capsys):
    """run= applies the training loader's scaling to 0-255 colours of a
    scannet artifact: its detections are the live pipeline's on colour /
    256, score for score and centre for centre, as the reference's are."""
    (_, tcfg, _, tm, ms), path, manifest, *_ = exported["colour"]
    assert manifest["source_dataset"] == "scannet"
    rng = np.random.default_rng(2)
    raw = np.concatenate([rng.uniform(-3, 3, (512, 3)),
                          rng.uniform(0, 255, (512, 3))], 1).astype(np.float32)
    scene = tmp_path / "scene.npy"
    np.save(scene, raw)
    capsys.readouterr()
    serving.main([f"run={path}", f"scene={scene}", "device=cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    pts = np.zeros((2, 512, 3), np.float32)
    feats = np.zeros((2, 512, 3), np.float32)
    mask = np.zeros((2, 512), bool)
    pts[0], feats[0], mask[0] = raw[:, :3], raw[:, 3:6] / 256.0, True
    live = serving.build_inference_fn(tcfg, tm, ms, with_features=True)(
        _t(pts), _t(mask), _t(feats))
    kept = np.nonzero(live["keep"][0].numpy())[0]
    assert len(out["detections"]) == len(kept) > 0
    for det, i in zip(out["detections"], kept):
        assert det["score"] == float(live["obj_prob"][0, i])
        np.testing.assert_array_equal(np.asarray(det["center"], np.float32),
                                      live["center"][0, i].numpy())


@pytest.mark.parametrize("points", [300, 512, 700],
                         ids=["short", "exact", "oversized"])
@pytest.mark.parametrize("columns,source", [(3, ""), (6, ""), (6, "scannet"),
                                            (3, "scannet")])
def test_prepare_scene_batch_equals_reference(points, columns, source):
    """Bitwise the reference's numpy: the default_rng(0) subsample without
    replacement, the zero pad with mask=False, colour columns 3:6 (/ 256
    for scannet) where the artifact takes features."""
    raw = np.random.default_rng(points + columns).uniform(
        0, 255, (points, columns)).astype(np.float32)
    manifest = {"batch_size": 2, "num_points": 512,
                "with_features": columns == 6 or bool(source),
                "source_dataset": source}
    got = serving.prepare_scene_batch(raw, manifest, device="cpu")
    want = jserving.prepare_scene_batch(raw, manifest)
    assert len(got) == len(want) == (3 if manifest["with_features"] else 2)
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    mask = got[1].numpy()
    assert mask[0].sum() == min(points, 512) and not mask[1].any()
    if points > 512:
        assert len({tuple(p) for p in got[0][0].numpy()}) == 512


def _detector_batch():
    b = detection_batch(np.random.default_rng(3), 2, 512, 4, 8)
    return {k: _t(v) for k, v in b.items()}


def _train_step(cfg, model):
    """One train step (train_lib) on a fresh optimizer: (loss, the
    parameters that got a gradient, all parameters)."""
    opt = train_lib.make_optimizer(cfg.train, 10, model.parameters())
    step = train_lib.make_detector_steps(model, opt, cfg)
    metrics = step(_detector_batch(), torch.Generator().manual_seed(0), 0.9)
    grads = [p for p in model.parameters() if p.grad is not None]
    return metrics["loss"], grads, list(model.parameters())


def test_training_after_serving_and_export_in_one_process(tmp_path):
    """Serving first creates the detector's host constants (the mean
    sizes, the corner signs); a train step with the same mean sizes must
    still take gradients through them, and again after an export traced
    them. The cache is cleared first so serving is its first user."""
    constants._constant.cache_clear()
    tcfg, tm, ms = _port_model(_OVERRIDES, 10)
    pts, mask = map(_t, _scene(np.random.default_rng(4)))
    served = serving.build_inference_fn(tcfg, tm, ms)(pts, mask)
    assert served["keep"].any()
    for cached in _cache_values():
        assert not cached.is_inference()

    for stage in ("after serving", "after export"):
        loss, grads, params = _train_step(tcfg, tm)
        assert torch.isfinite(loss), stage
        assert len(grads) == len(params), stage
        assert all(torch.isfinite(g.grad).all() for g in grads), stage
        if stage == "after serving":
            serving.export_detector(tcfg, tm, ms, 2, str(tmp_path / "m.pt2"))
    from torch._subclasses.fake_tensor import FakeTensor

    for cached in _cache_values():
        assert not cached.is_inference() and not isinstance(cached,
                                                            FakeTensor)


def _cache_values():
    """The tensors in the host-constant cache, found by asking it again
    for the constants the small detector uses (each a hit)."""
    from tpu3dsad_torch.ops.boxes import _CORNER_SIGNS

    before = constants._constant.cache_info()
    out = [constants.device_constant(v, "cpu")
           for v in (class_mean_sizes(4), _CORNER_SIGNS)]
    assert constants._constant.cache_info().hits == before.hits + 2
    return out


def _opcheck_cases():
    rng = np.random.default_rng(5)
    xyz = _t(rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32))
    centers = xyz[:, :8].clone()
    mask = _t(rng.random((2, 64)) < 0.8)
    perm = torch.stack([torch.randperm(64, generator=torch.Generator()
                                       .manual_seed(b)) for b in range(2)])
    perm_c = torch.stack([torch.randperm(8, generator=torch.Generator()
                                         .manual_seed(b)) for b in range(2)])
    corners = tboxes.box_corners(
        centers, _t(rng.uniform(0.2, 1.0, (2, 8, 3)).astype(np.float32)),
        _t(rng.uniform(-np.pi, np.pi, (2, 8)).astype(np.float32)))
    return {
        "fps": (library.fps, (xyz, 16, None)),
        "fps_masked": (library.fps, (xyz, 16, mask)),
        "ball_query": (library.ball_query, (xyz, centers, 0.5, 8, None)),
        "ball_query_masked": (library.ball_query,
                              (xyz, centers, 0.5, 8, mask)),
        "ball_query_permuted": (library.ball_query,
                                (xyz, centers, 0.5, 8, mask, perm, perm_c)),
        "morton_codes": (library.morton_codes, (xyz, centers, mask)),
        "fp32_cross": (ops.plain.knn.fp32_cross, (xyz, centers)),
        "greedy_suppress": (library.greedy_suppress,
                            (tboxes.aabb_iou_3d(xyz, xyz + 0.5, xyz,
                                                xyz + 0.5),
                             xyz[..., 0].contiguous(), mask, 0.25)),
        "oriented_bev_iou": (library.oriented_bev_iou,
                             (corners, corners[:, :5])),
        "bn_relu": (library.bn_relu,
                    (xyz - 0.1, *(_t(rng.uniform(0.2, 2, 3).astype(
                        np.float32)) for _ in range(4)), 1e-5)),
    }


@pytest.mark.parametrize("case", list(_opcheck_cases()))
def test_custom_ops_pass_opcheck(case):
    """Schema, fake (shape) version, autograd registration and AOT
    dispatch of each custom op on the CPU, and its outputs there equal the
    plain versions'."""
    op, args = _opcheck_cases()[case]
    torch.library.opcheck(op, args)
    got = op(*args)
    if op is ops.plain.knn.fp32_cross:
        assert torch.equal(got, torch.bmm(args[0], args[1].transpose(1, 2)))
        return
    if op is library.oriented_bev_iou:
        assert torch.equal(got, ops.plain.oriented_bev_iou(*args))
        assert got.any()  # some boxes overlap
        return
    if op is library.bn_relu:
        assert torch.equal(got, ops.plain.bn_relu(*args))
        assert 0 < int((got > 0).sum()) < got.numel()  # some rows clipped
        return
    if op is library.greedy_suppress:
        assert got.dtype == torch.bool
        assert torch.equal(got, ops.plain.greedy_suppress(*args))
        assert 0 < got.sum() < args[2].sum()  # some kept, some suppressed
        return
    if op is library.fps:
        want = ops.plain.furthest_point_sample(*args[:2], mask=args[2])
    elif op is library.morton_codes:
        want = tsorted.z_keys(*args)
    elif len(args) == 5:
        want = ops.plain.ball_query(*args[:4], mask=args[4])
    else:
        xs, cs, perm, inv_c = tsorted.permuted_views(args[0], args[1],
                                                     *args[4:])
        want = tsorted.map_back(*ops.plain.ball_query(xs, cs, *args[2:4]),
                                perm, inv_c)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == torch.int32 and torch.equal(g, w)


def test_permuted_scan_by_sort_order_is_the_sorted_tier():
    """The ball-query op given the Morton codes' stable sorts equals the
    plain sorted tier (sorted_views + plain + map_back), as the card's
    sorted path composes it."""
    xyz, mask = map(_t, _scene(np.random.default_rng(6), n=256)[:2])
    centers = xyz[:, ::8].contiguous()
    codes_x, codes_c = library.morton_codes(xyz, centers, mask)
    perm = torch.sort(codes_x, dim=1, stable=True).indices
    perm_c = torch.sort(codes_c, dim=1, stable=True).indices
    got = library.ball_query(xyz, centers, 0.6, 8, mask, perm, perm_c)
    want = tsorted.sorted_ball_query(xyz, centers, 0.6, 8, mask=mask)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_sorted_tier_exports_equal_to_eager(tmp_path):
    """Under ops_fast_grouping=true ops_fast_mode=sorted at the sorted
    tier's real gate (SA1's support of 8192 points, K = 8), the program
    holds one morton_codes node (SA1) and the reloaded program equals the
    eager one bitwise."""
    args = [a.replace("data.num_points=512", "data.num_points=8192")
            for a in _OVERRIDES] + ["ops_fast_grouping=true",
                                    "ops_fast_mode=sorted"]
    tcfg, tm, ms = _port_model(args, 11)
    pts, mask = map(_t, _scene(np.random.default_rng(7), b=1, n=8192))
    assert tsorted.applies(8192, tcfg.model.sa_nsamples[0])
    train_lib.apply_runtime_config(tcfg)
    try:
        live = serving.build_inference_fn(tcfg, tm, ms)(pts, mask)
        path = str(tmp_path / "sorted.pt2")
        serving.export_detector(tcfg, tm, ms, 1, path)
        program = serving.load(path)
        with torch.no_grad():
            got = program.module()(pts, mask)
        train_lib.apply_runtime_config(Config())
        exact = serving.build_inference_fn(tcfg, tm, ms)(pts, mask)
    finally:
        train_lib.apply_runtime_config(Config())
    _equal(got, live)
    assert not torch.equal(exact["center"], live["center"])  # another tier
    calls = Counter(str(node.target) for node in program.graph.nodes)
    assert calls["tpu3dsad_torch.morton_codes.default"] == 1
    assert calls["tpu3dsad_torch.ball_query.default"] == 7


def test_exported_program_keeps_the_distance_product_in_fp32(
        exported, monkeypatch):
    """The loaded program runs three_nn's cross term with TF32 off, as
    the eager path does, even where the process lets matmuls run as TF32
    (train.bf16_matmul): the switch is a node of the graph."""
    seen = []
    bmm = torch.bmm

    def spy(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return bmm(*args, **kwargs)

    program = exported["points"][3].module()
    pts, mask = map(_t, _scene(np.random.default_rng(9)))
    monkeypatch.setattr(torch, "bmm", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with torch.no_grad():
        program(pts, mask)
    assert seen == [False, False]
    assert torch.backends.cuda.matmul.allow_tf32


def test_cpu_serving_launches_no_kernel(exported):
    before = (cuda_fps.launches, cuda_bq.launches, cuda_scatter.launches,
              tsorted.launches, cuda_nms.launches, cuda_bn_relu.launches)
    (_, tcfg, _, tm, ms), _, _, program, *_ = exported["points"]
    pts, mask = map(_t, _scene(np.random.default_rng(8)))
    with torch.no_grad():
        program.module()(pts, mask)
    assert (cuda_fps.launches, cuda_bq.launches, cuda_scatter.launches,
            tsorted.launches, cuda_nms.launches,
            cuda_bn_relu.launches) == before


# ------------------------------------------------------- dump and demo


def test_dump_writers_write_the_reference_bytes(tmp_path):
    """tests/eval/test_dump.py's checks, and byte equality with the
    reference's writers on the same arrays."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((10, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (10, 3)).astype(np.uint8)
    corners = rng.standard_normal((3, 8, 3)).astype(np.float32)
    for mod, name in ((dump, "port"), (jdump, "ref")):
        mod.write_ply(str(tmp_path / f"{name}_rgb.ply"), pts, colors)
        mod.write_ply(str(tmp_path / f"{name}.ply"), pts)
        mod.write_boxes_obj(str(tmp_path / f"{name}.obj"), corners)
    for f in ("_rgb.ply", ".ply", ".obj"):
        assert filecmp.cmp(tmp_path / f"port{f}", tmp_path / f"ref{f}",
                           shallow=False), f
    lines = (tmp_path / "port_rgb.ply").read_text().splitlines()
    assert lines[0] == "ply" and "element vertex 10" in lines
    body = lines[lines.index("end_header") + 1:]
    assert len(body) == 10
    assert [int(x) for x in body[0].split()[3:]] == list(colors[0])
    obj = (tmp_path / "port.obj").read_text().splitlines()
    verts = [line for line in obj if line.startswith("v ")]
    edges = [line for line in obj if line.startswith("l ")]
    assert len(verts) == 24 and len(edges) == 36  # 8 and 12 a box
    for e in edges:
        assert all(1 <= int(i) <= 24 for i in e.split()[1:])


def test_dump_results_writes_the_reference_files(tmp_path):
    """One scene's points, kept predicted boxes and ground-truth boxes:
    the same files as the reference's dump_results on the same batch and
    parsed fields."""
    batch = detection_batch(np.random.default_rng(9), 2, 256, 4, 8)
    batch["point_mask"][0, 200:] = False
    rng = np.random.default_rng(10)
    parsed = {"keep": rng.random((2, 16)) < 0.5,
              "corners": rng.standard_normal((2, 16, 8, 3)).astype(
                  np.float32)}
    dump.dump_results(str(tmp_path / "port"), batch,
                      {k: _t(v) for k, v in parsed.items()})
    jdump.dump_results(str(tmp_path / "ref"), batch, parsed)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == ["gt_boxes.obj", "points.ply", "pred_boxes.obj"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "port",
                                           tmp_path / "ref", names,
                                           shallow=False)
    assert not mismatch and not errors


def test_demo_cli_default_path(tmp_path):
    """tests/e2e/test_demo.py: with no checkpoint the demo runs on random
    weights and writes its files."""
    out = demo.main([f"out={tmp_path}", "device=cpu", *_OVERRIDES,
                     f"train.ckpt_dir={tmp_path}/no_ckpt"])
    with open(tmp_path / "detections.json") as f:
        assert json.load(f) == out
    assert out["ckpt_step"] == 0 and isinstance(out["detections"], list)
    for name in ("points.npy", "points.ply", "gt_boxes.obj"):
        assert (tmp_path / name).exists(), name


def test_demo_on_a_checkpoint_matches_the_served_program(tmp_path):
    """A fabricated checkpoint: the demo restores it; its scene is the
    reference demo's (the reference's synthetic train_batch of
    default_rng(7)), its detections the eager program's on that scene, and
    its files the reference's writers' on them."""
    tcfg, tm, ms = _port_model(_OVERRIDES, 12)
    opt = train_lib.make_optimizer(tcfg.train, 10, tm.parameters())
    ckpt = tmp_path / "ckpt"
    train_lib.save_checkpoint(str(ckpt), tm, opt, 3)
    args = [*_OVERRIDES, f"train.ckpt_dir={ckpt}"]
    out = demo.main([f"out={tmp_path / 'port'}", "device=cpu", *args])
    assert out["ckpt_step"] == 3

    batch = detection_batch(np.random.default_rng(7), 1, 512, 4, 8)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "points.npy"),
                                  batch["points"][0])
    live = serving.build_inference_fn(tcfg, tm, ms)(
        _t(batch["points"]), _t(batch["point_mask"]))
    want = serving.detections(live)
    assert [(d["center"], d["size"], d["heading"], d["score"], d["class"])
            for d in out["detections"]] == [
        (d["center"], d["size"], d["heading"], d["score"], d["class"])
        for d in want]
    assert want
    ref = tmp_path / "ref"
    host = {k: v.numpy() for k, v in live.items()}
    host["corners"] = tboxes.box_corners(
        live["center"], live["size"], live["heading"]).numpy()
    jdump.dump_results(str(ref), batch, host)
    for name in ("points.ply", "pred_boxes.obj"):
        assert filecmp.cmp(ref / name, tmp_path / "port" / name,
                           shallow=False), name


def test_entry_points_import_without_jax():
    """serving, demo, utils.dump, the train entry, the importer and the
    raw-release converters load neither JAX, nor the JAX package, nor the
    tests, and the serving CLI asks for its arguments."""
    code = (
        "import sys\n"
        "import tpu3dsad_torch.serving, tpu3dsad_torch.demo\n"
        "import tpu3dsad_torch.utils.dump, tpu3dsad_torch.ops.library\n"
        "import tpu3dsad_torch.train, tpu3dsad_torch.utils.import_torch\n"
        "import tpu3dsad_torch.data.preproc_scannet\n"
        "import tpu3dsad_torch.data.preproc_kitti\n"
        "import tpu3dsad_torch.data.preproc_sunrgbd\n"
        "bad = [m for m in sys.modules if m.split('.')[0]\n"
        "       in ('jax', 'flax', 'optax', 'tpu3dsad', 'tests')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    with pytest.raises(SystemExit, match="ckpt=<dir> out=<path>"):
        serving.main([])
