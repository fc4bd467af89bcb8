"""Config-#4 training in the PyTorch port held against the JAX package on
the CPU: the oriented BEV IoU and the BEV / oriented NMS, density-biased
proposal sampling, the lineage proposal head, the loss without scale
logits, the KITTI loader's training batches (augmentation, compact votes),
one outdoor train step, and run_detector with every option at once.

Tolerances, with their reasons:

  * oriented BEV IoU: rtol 1e-5, atol 1e-6 (the same fp32 polygon clip,
    its shoelace sums in another order), and within 1e-4 of the host
    evaluator (eval/ap.py), the JAX test's bar;
  * proposal heads and the lineage-mode detector from bridged weights:
    rtol 1e-5 for the heads on identical votes, with atol 1e-6 in eval
    mode and 1e-5 in train mode (train-mode BatchNorm divides by the
    batch's own std over 16 proposals, which scales the fp32 rounding of
    its statistics up by ~1/std); the detector end to end at
    test_torch_detector.py's rtol 1e-4, atol 1e-5 (fp32 matmuls summed in
    another order through the backbone), in train mode with the atol
    times the tensor's largest magnitude where that exceeds 1 (every
    BatchNorm of the backbone normalises by batch statistics);
  * the loss without scale logits: rtol 1e-5, atol 1e-6;
  * one train step: loss within rel 1e-4, as test_torch_train.py.

Integers are equal: vote densities (the strict d2 < r2 boundary too),
density-FPS picks and masks, NMS keep masks. The loader's batches are
bitwise the reference's: both read the same FPS caches, written once by
the plain FPS before either loads, so the native FPS plays no part.
"""

import copy
import dataclasses
import json
import shutil

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
from tpu3dsad import train_lib as jtrain
from tpu3dsad.data import kitti as jkitti
from tpu3dsad.data.device_pipeline import decode_compact_votes as j_decode
from tpu3dsad.data.synthetic import class_mean_sizes, detection_batch
from tpu3dsad.eval.ap import box3d_iou_oriented
from tpu3dsad.models import proposal as jprop
from tpu3dsad.models.detector import SizeAdaptiveDetector as JDetector
from tpu3dsad.ops import boxes as jboxes
from tpu3dsad.ops import nms as jnms
from tpu3dsad.presets import expand as j_expand
from tpu3dsad.serving import build_inference_fn as j_build_inference_fn
from tpu3dsad_torch import losses as tlosses
from tpu3dsad_torch import train_lib
from tpu3dsad_torch.data import synthetic_outdoor as tso
from tpu3dsad_torch.data.augment import resolve_aug
from tpu3dsad_torch.data.device_pipeline import decode_compact_votes
from tpu3dsad_torch.data.packed import pack_dataset
from tpu3dsad_torch.data.registry import get_dataset
from tpu3dsad_torch.models import proposal as tprop
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.ops import boxes as tboxes
from tpu3dsad_torch.ops import nms as tnms
from tpu3dsad_torch.serving import build_inference_fn
from tpu3dsad_torch.train_detector import run_detector
from tpu3dsad_torch.utils.bridge import (
    load_flax_variables,
    state_dict_from_flax,
)

from test_torch_detector import SMALL, to_port
from test_torch_hostfed import TINY_MODEL, _equal
from test_torch_nn import randomize
from test_torch_train import GRAD_ATOL, GRAD_RTOL

RTOL, ATOL = 1e-5, 1e-6
TRAIN_ATOL = 1e-5
E2E_RTOL, E2E_ATOL = 1e-4, 1e-5


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------- oriented BEV IoU


def _boxes(rng, k, lo=-3.0, hi=3.0):
    center = rng.uniform(lo, hi, (k, 3)).astype(np.float32)
    size = rng.uniform(0.5, 3.0, (k, 3)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, k).astype(np.float32)
    return center, size, heading


def _corners(center, size, heading):
    return np.asarray(jboxes.box_corners(
        jnp.asarray(center), jnp.asarray(size), jnp.asarray(heading)))


def _iou_case(case):
    """(corners_a [1,K,8,3], corners_b [1,L,8,3]) of one kind of pair."""
    rng = np.random.default_rng(3)
    c, s, h = _boxes(rng, 24)
    a = _corners(c, s, h)
    if case == "random":
        b = _corners(*_boxes(rng, 20))
    elif case == "identical":
        b = a.copy()
    elif case == "rotated_duplicate":  # the same box turned by k * 90 deg
        turn = np.float32(np.pi / 2) * rng.integers(1, 4, len(h))
        b = _corners(c, s, (h + turn).astype(np.float32))
    elif case == "touching":  # b's -x face on a's +x face, same heading
        shift = np.stack([np.cos(h), np.sin(h), np.zeros_like(h)], -1) * s[
            :, :1]
        b = _corners((c + shift).astype(np.float32), s, h)
    else:  # disjoint
        b = _corners(c + np.float32(100.0), s, h)
    return a[None], b[None]


@pytest.mark.parametrize("case", ["random", "identical", "rotated_duplicate",
                                  "touching", "disjoint"])
def test_oriented_bev_iou_equals_reference(case):
    a, b = _iou_case(case)
    want = np.asarray(jax.jit(jboxes.oriented_bev_iou)(a, b))
    got = tboxes.oriented_bev_iou(_t(a), _t(b))
    _close(got, want)
    got = got.numpy()[0]
    if case in ("random", "identical"):
        # the host evaluator's geometry; its sequential clip is not held
        # to the degenerate cases: a box and its 180-degree turn, whose
        # corners agree to an ulp in another order, score 0.456 there
        for i in range(0, a.shape[1], 3):
            for j in range(b.shape[1]):
                host = box3d_iou_oriented(a[0, i], b[0, j])
                assert abs(got[i, j] - host) < 1e-4, (i, j, got[i, j], host)
    if case == "identical":
        np.testing.assert_allclose(np.diag(got), 1.0, atol=1e-5)
    if case in ("touching", "disjoint"):
        assert np.abs(np.diag(got)).max() < 1e-4
    if case == "disjoint":
        assert not got.any()


@pytest.mark.parametrize("cls_nms", [False, True])
@pytest.mark.parametrize("mode", ["bev", "oriented"])
def test_nms_equals_reference(mode, cls_nms):
    rng = np.random.default_rng(8)
    B, K = 3, 40
    center = rng.uniform(-1, 1, (B, K, 3)).astype(np.float32)
    size = rng.uniform(0.3, 1.2, (B, K, 3)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, (B, K)).astype(np.float32)
    scores = rng.choice([0.2, 0.5, 0.9], (B, K)).astype(np.float32)  # ties
    valid = rng.random((B, K)) < 0.8
    sem = rng.integers(0, 3, (B, K))
    corners = _corners(center, size, heading)
    bmin, bmax = corners.min(-2), corners.max(-2)
    kw = dict(sem_cls=sem if cls_nms else None)
    if mode == "bev":
        want = jax.jit(lambda *a: jnms.nms_bev(*a, 0.25, **kw))(
            bmin, bmax, scores, valid)
        got = tnms.nms_bev(_t(bmin), _t(bmax), _t(scores), _t(valid), 0.25,
                           sem_cls=_t(kw["sem_cls"]))
    else:
        want = jax.jit(lambda *a: jnms.nms_oriented(*a, 0.25, **kw))(
            corners, scores, valid)
        got = tnms.nms_oriented(_t(corners), _t(scores), _t(valid), 0.25,
                                sem_cls=_t(kw["sem_cls"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < valid.sum()  # some boxes suppressed


# --------------------------------------------- density-biased sampling


def _density_case(case):
    """(x [B,V,3], valid [B,V], r): random with a mask, the boundary, and
    the slab path (V = 2048 makes 1024-row slabs)."""
    rng = np.random.default_rng(11)
    if case == "boundary":
        # from the origin: d2 == r2 exactly, and one ulp inside
        inside = np.nextafter(np.float32(0.5), np.float32(0))
        x = np.zeros((1, 64, 3), np.float32)
        x[0, 1:21, 0] = 0.5
        x[0, 21:40, 1] = -inside
        x[0, 40:] = rng.uniform(2, 3, (24, 3))
        return x, np.ones((1, 64), bool), 0.5
    V = 2048 if case == "slab" else 300
    x = rng.uniform(-1, 1, (2, V, 3)).astype(np.float32)
    valid = rng.random((2, V)) < 0.85
    return x, valid, 0.3


@pytest.mark.parametrize("case", ["masked", "boundary", "slab"])
def test_vote_density_equals_reference(case):
    x, valid, r = _density_case(case)
    r2 = np.float32(r) ** 2
    want = np.asarray(jprop._vote_density(jnp.asarray(x), jnp.asarray(valid),
                                          jnp.float32(r) ** 2))
    got = tprop._vote_density(_t(x), _t(valid), float(r2)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "boundary":
        # the origin counts itself and the 19 points one ulp inside; the
        # 20 at d2 == r2 stay out
        assert got[0, 0] == 20


def _fps_case(case):
    rng = np.random.default_rng(12)
    if case == "ties":  # integer grid: equal densities everywhere
        x = rng.integers(-3, 4, (2, 400, 3)).astype(np.float32)
        return x, None, 48, 1.5, 4
    x = rng.uniform(-1, 1, (2, 512, 3)).astype(np.float32)
    x[:, :128] *= 0.1  # a dense cluster of foreground-like votes
    mask = rng.random((2, 512)) < 0.8
    mask[1, 300:] = False
    factor = 100 if case == "all_candidates" else 4  # C == V
    return x, mask, 32, 0.2, factor


@pytest.mark.parametrize("case", ["masked", "ties", "all_candidates"])
def test_density_biased_fps_equals_reference(case):
    x, mask, P, r, factor = _fps_case(case)
    ji, jm = jprop.density_biased_fps(
        jnp.asarray(x), P, r, vote_mask=None if mask is None
        else jnp.asarray(mask), candidate_factor=factor)
    ti, tm = tprop.density_biased_fps(_t(x), P, r, vote_mask=_t(mask),
                                      candidate_factor=factor)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert ti.dtype == torch.int32


def test_density_selection_builds_no_backward():
    """The candidate gather feeds only FPS: a loss of the picked centers
    reaches vote_xyz through the centers' gather alone, one scatter."""
    x, mask, P, r, factor = _fps_case("masked")
    votes = _t(x).requires_grad_()
    calls = []
    scatter = tprop.ops.scatter_rows
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tprop.ops, "scatter_rows",
                   lambda *a: calls.append(a[0].shape) or scatter(*a))
        inds, _ = tprop.density_biased_fps(votes, P, r, vote_mask=_t(mask),
                                           candidate_factor=factor)
        assert not inds.requires_grad
        tprop.ops.gather(votes, inds).sum().backward()
    assert calls == [(2, P, 3)]


def test_unknown_sampling_raises_like_reference():
    with pytest.raises(ValueError, match="proposal_sampling='fsp'"):
        jprop._sample_proposal_centers(
            jnp.zeros((1, 8, 3)), 4, None, sampling="fsp",
            density_radius=0.3, candidate_factor=4)
    with pytest.raises(ValueError, match="proposal_sampling='fsp'"):
        tprop._sample_proposal_centers(
            torch.zeros(1, 8, 3), 4, None, sampling="fsp",
            density_radius=0.3, candidate_factor=4)
    head = tprop.SizeAdaptiveProposal(3, 8, sampling="fsp")
    with pytest.raises(ValueError, match="proposal_sampling='fsp'"):
        head(torch.zeros(1, 8, 3), torch.zeros(1, 8, 8))


# ------------------------------------------------------ proposal heads

HEAD_IN = 16


def _votes():
    rng = np.random.default_rng(13)
    xyz = rng.uniform(-1, 1, (2, 96, 3)).astype(np.float32)
    xyz[:, :40] *= 0.2
    feat = rng.normal(0, 1, (2, 96, HEAD_IN)).astype(np.float32)
    mask = np.ones((2, 96), bool)
    mask[1, 70:] = False
    return xyz, feat, mask


def _heads(kind):
    """(flax module, torch module) of one proposal head at a small size."""
    if kind == "lineage":
        kw = dict(num_classes=3, num_proposals=16, radius=0.3, nsample=8)
        return (jprop.LineageProposal(**kw),
                tprop.LineageProposal(in_dim=HEAD_IN, **kw))
    kw = dict(num_classes=3, num_proposals=16, radius_bank=(0.1, 0.3),
              nsample=8, feat_dim=32, sampling="density",
              density_radius=0.2, candidate_factor=3)
    return (jprop.SizeAdaptiveProposal(**kw),
            tprop.SizeAdaptiveProposal(in_dim=HEAD_IN, **kw))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", ["lineage", "density"])
def test_proposal_head_equals_reference(kind, train):
    jm, tm = _heads(kind)
    xyz, feat, mask = _votes()
    args = (jnp.asarray(xyz), jnp.asarray(feat))
    var = randomize(jm.init(jax.random.key(1), *args,
                            vote_mask=jnp.asarray(mask)), seed=3)
    load_flax_variables(tm, var)
    want, upd = jax.jit(lambda v, x, f, m: jm.apply(
        v, x, f, vote_mask=m, train=train, bn_momentum=0.8,
        mutable=["batch_stats"]))(var, *args, jnp.asarray(mask))
    tm.train(train)
    with torch.no_grad():
        got = tm(_t(xyz), _t(feat), vote_mask=_t(mask), bn_momentum=0.8)
    assert set(got) == set(want)
    assert ("scale_logits" in got) == (kind != "lineage")
    for key, w in want.items():
        w = np.asarray(w)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)
        else:
            _close(got[key], w, atol=TRAIN_ATOL if train else ATOL, msg=key)
    stats = state_dict_from_flax({"batch_stats": upd["batch_stats"]},
                                 {k: v for k, v in tm.state_dict().items()
                                  if "running" in k})
    for key, w in stats.items():
        _close(tm.state_dict()[key], w, msg=key)


LINEAGE = dataclasses.replace(SMALL, proposal_mode="lineage",
                              proposal_radius=0.2)


@pytest.fixture(scope="module")
def lineage_pair():
    """(jax model, flax variables, torch model, points, mask) of the
    lineage-mode detector, one scene with a padded tail."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-0.5, 0.5, (2, 512, 3)).astype(np.float32)
    mask = np.ones((2, 512), bool)
    mask[1, 400:] = False
    pts[1, 400:] = 50.0
    jm = JDetector(LINEAGE)
    var = jax.jit(lambda k: jm.init(k, jnp.asarray(pts), mask=jnp.asarray(mask),
                                    train=False))(jax.random.key(0))
    var = randomize(var, seed=7)
    tm = SizeAdaptiveDetector(to_port(LINEAGE), device="cpu")
    load_flax_variables(tm, var)  # the lineage head's leaves bridge whole
    return jm, var, tm, pts, mask


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_lineage_detector_end_points_equal_reference(lineage_pair, train):
    jm, var, tm, pts, mask = lineage_pair
    ep, _ = jax.jit(lambda v, p, m: jm.apply(
        v, p, mask=m, train=train, bn_momentum=0.8,
        mutable=["batch_stats"]))(var, jnp.asarray(pts), jnp.asarray(mask))
    tm = copy.deepcopy(tm)  # train mode moves the running statistics
    tm.train(train)
    with torch.no_grad():
        got = tm(_t(pts), mask=_t(mask), bn_momentum=0.8)
    assert set(got) == set(ep) and "scale_logits" not in got
    for key, want in ep.items():
        want, have = np.asarray(want), got[key].numpy()
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(have, want, err_msg=key)
        else:
            # train mode: the atol scales with the tensor (module docstring)
            atol = E2E_ATOL * (max(1.0, np.abs(want).max()) if train else 1)
            np.testing.assert_allclose(have, want, rtol=E2E_RTOL, atol=atol,
                                       err_msg=key)


@pytest.mark.parametrize("nms", ["3d", "bev", "oriented"])
def test_served_keep_equals_reference_in_every_nms_mode(lineage_pair, nms):
    jm, var, tm, pts, mask = lineage_pair
    ev = jconfig.EvalConfig(use_3d_nms=nms != "bev",
                            use_oriented_nms=nms == "oriented", nms_iou=0.1)
    cfg = jconfig.Config(model=LINEAGE, eval=ev)
    jout = j_build_inference_fn(cfg, var, tm.mean_sizes)(jnp.asarray(pts),
                                                          jnp.asarray(mask))
    tout = build_inference_fn(to_port(cfg), tm, tm.mean_sizes)(
        _t(pts), _t(mask))
    keep = tout["keep"].numpy()
    np.testing.assert_array_equal(keep, np.asarray(jout["keep"]))
    assert 0 < keep.sum() < keep.size


def test_detection_loss_without_scale_logits_equals_reference(lineage_pair):
    jm, var, tm, pts, mask = lineage_pair
    batch = detection_batch(np.random.default_rng(5), 2, 512,
                            LINEAGE.num_classes, 8, vote_candidates=3)
    ep = jax.jit(lambda v, p, m: jm.apply(v, p, mask=m, train=False))(
        var, jnp.asarray(batch["points"]), jnp.asarray(batch["point_mask"]))
    ms = class_mean_sizes(LINEAGE.num_classes)
    bank = tuple(LINEAGE.cluster_radius_bank)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jmet = jax.jit(lambda e, b: jlosses.detection_loss(
        e, b, ms, 12, bank))(ep, jb)
    tep = {k: _t(v) for k, v in ep.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    tloss, tmet = tlosses.detection_loss(tep, tb, ms, 12, bank)
    assert set(tmet) == set(jmet)
    for k, w in jmet.items():
        _close(tmet[k], w, msg=k)
    assert tmet["scale_sel_loss"].item() == 0.0
    _close(tloss, jloss)


# -------------------------------------------------------- KITTI loader

RAW, BUDGET = 40000, 1024


def _outdoor_args(root, *extra):
    return ["preset=outdoor", f"data.root={root}",
            f"data.num_points={BUDGET}", "train.batch_size=2", *TINY_MODEL,
            *extra]


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """3 train and 2 val scenes of 40000 points (seed 1) with their FPS
    caches, written once by the plain FPS before any test loads them."""
    root = tmp_path_factory.mktemp("kitti")
    tso.write_dataset(str(root), scenes=3, val_scenes=2, num_points=RAW,
                      seed=1)
    cfg = tconfig.parse_cli(_outdoor_args(root, "data.augment=false"))
    ds = get_dataset(cfg, device="cpu")
    for item in ds.train_items + ds.val_items:
        ds._load_scene(*item, np.random.default_rng(0), False)
    assert len(list(root.rglob(f"*_fpscache_{BUDGET}.npy"))) == 5
    return root


def _both_loaders(root, *extra):
    args = _outdoor_args(root, *extra)
    port = tconfig.parse_cli(args)
    ref = jconfig.apply_overrides(jconfig.Config(), j_expand(args))
    return (get_dataset(port, device="cpu"),
            jkitti.KittiDetectionDataset(ref))


@pytest.mark.parametrize("augment,compact", [(True, False), (True, True),
                                             (False, True)])
def test_kitti_train_batch_equals_reference(kitti_root, augment, compact):
    tds, jds = _both_loaders(kitti_root, f"data.augment={augment}",
                             f"data.compact_votes={compact}")
    for seed in (0, 1):
        got = tds.train_batch(np.random.default_rng(seed), 4)
        want = jds.train_batch(np.random.default_rng(seed), 4)
        _equal(got, want, msg=seed)
    assert ("vote_owner" in got) == compact
    if compact:  # the decode rebuilds the expanded batch's targets
        full, _ = _both_loaders(kitti_root, f"data.augment={augment}")
        expanded = full.train_batch(np.random.default_rng(1), 4)
        dec = decode_compact_votes({k: _t(v) for k, v in got.items()}, 3)
        jdec = j_decode({k: jnp.asarray(v) for k, v in got.items()}, 3)
        for key in ("vote_targets", "vote_mask"):
            assert dec[key].numpy().tobytes() == expanded[key].tobytes(), key
            np.testing.assert_array_equal(dec[key].numpy(),
                                          np.asarray(jdec[key]))


def test_packed_kitti_split_trains_with_the_kitti_recipe(kitti_root,
                                                         tmp_path):
    src = tconfig.parse_cli(_outdoor_args(kitti_root, "data.augment=false",
                                          "data.compact_votes=true"))
    counts = pack_dataset(get_dataset(src, device="cpu"),
                          str(tmp_path / "packed"))
    assert counts == {"train": 3, "val": 2}
    cfg = tconfig.parse_cli(_outdoor_args(
        tmp_path / "packed", "data.name=packed", "data.device_augment=true",
        "data.compact_votes=true", "train.num_epochs=1", "train.eval_every=1",
        f"train.ckpt_dir={tmp_path / 'ckpt'}"))
    ds = get_dataset(cfg, device="cpu")
    assert ds.source_dataset == "kitti"
    assert resolve_aug(cfg.data, ds.source_dataset) == resolve_aug(
        cfg.data, "kitti")
    result = run_detector(cfg, device="cpu")
    assert result.step == 1 and np.isfinite(result.history[0]["loss"])
    assert np.isfinite(result.evals[0]["val_loss"])


# ------------------------------------------------------ one train step


@pytest.fixture(scope="module")
def outdoor_batch(kitti_root):
    """One augmented KITTI training batch (expanded votes) of 2 scenes."""
    tds, _ = _both_loaders(kitti_root, "data.augment=true")
    return tds.train_batch(np.random.default_rng(4), 2)


@pytest.mark.parametrize("option", [
    "model.proposal_sampling=fps", "model.proposal_sampling=density",
    "model.proposal_mode=lineage"])
def test_outdoor_train_step_matches_reference(kitti_root, outdoor_batch,
                                              option):
    args = _outdoor_args(kitti_root, option)
    ref = jconfig.apply_overrides(jconfig.Config(), j_expand(args))
    cfg = to_port(ref)
    jm = JDetector(ref.model)
    b = outdoor_batch
    var = jax.jit(lambda k: jm.init(
        k, jnp.asarray(b["points"]), mask=jnp.asarray(b["point_mask"]),
        train=False))(jax.random.key(2))
    ms = jkitti.KITTI_MEAN_SIZES
    bn_m = float(jtrain.bn_momentum_at(ref.train, 0))
    m = ref.model

    def lf(p):
        ep, _ = jm.apply({"params": p, "batch_stats": var["batch_stats"]},
                         jnp.asarray(b["points"]),
                         mask=jnp.asarray(b["point_mask"]), train=True,
                         bn_momentum=bn_m, mutable=["batch_stats"])
        loss, _ = jlosses.detection_loss(
            ep, {k: jnp.asarray(v) for k, v in b.items()}, ms,
            m.num_heading_bins, tuple(m.cluster_radius_bank),
            near=m.assign_near, far=m.assign_far,
            center_norm=m.center_loss_norm)
        return loss

    jloss, jgrads = jax.jit(jax.value_and_grad(lf))(var["params"])
    model = SizeAdaptiveDetector(cfg.model, ms, device="cpu")
    load_flax_variables(model, var)
    model.train()
    # SA1's first weight gradient is one long fp32 reduction, which the
    # one-thread CPU GEMM sums in a longer chain than its 8-thread path:
    # with density sampling it lands 1.3x over this bar on one thread and
    # at 0.6x on 8, where the step has always run (every other gradient
    # moves by ~1% of the bar)
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        loss, _ = train_lib.detector_loss(
            model, cfg, {k: _t(v) for k, v in b.items()},
            train_lib.bn_momentum_at(cfg.train, 0))
        loss.backward()
    finally:
        torch.set_num_threads(threads)
    assert loss.item() == pytest.approx(float(jloss), rel=1e-4)
    params = dict(model.named_parameters())
    jg = state_dict_from_flax({"params": jgrads}, params)
    gmax = max(g.abs().max().item() for g in jg.values())
    for name, want in jg.items():
        err = (params[name].grad - want).abs().max().item()
        assert err <= GRAD_RTOL * want.abs().max().item() + GRAD_ATOL * gmax, \
            name


@pytest.mark.parametrize("option,want", [
    ("model.proposal_sampling=fps", (5, 7, 9)),
    ("model.proposal_sampling=density", (5, 7, 9)),
    ("model.proposal_mode=lineage", (5, 5, 7)),
])
def test_kernel_calls_of_one_outdoor_step(outdoor_batch, option, want):
    """The FPS, ball-query and scatter calls of one outdoor train step on
    the plain path: the launches chip_smoke.py's phase 11 requires of the
    kernels a step (STEP4 there)."""
    cfg = tconfig.parse_cli(_outdoor_args("unused", option))
    model = SizeAdaptiveDetector(cfg.model, jkitti.KITTI_MEAN_SIZES,
                                 device="cpu")
    model.train()
    seen = {"furthest_point_sample": 0, "ball_query": 0, "scatter_rows": 0}
    plain = tprop.ops._plain
    with pytest.MonkeyPatch.context() as mp:
        for name in seen:
            fn = getattr(plain, name)

            def counted(*a, _fn=fn, _name=name, **k):
                seen[_name] += 1
                return _fn(*a, **k)
            mp.setattr(plain, name, counted)
        loss, _ = train_lib.detector_loss(
            model, cfg, {k: _t(v) for k, v in outdoor_batch.items()}, 0.5)
        loss.backward()
    assert tuple(seen.values()) == want


# ------------------------------------------------------- run_detector


@pytest.mark.parametrize("options", [
    ["data.compact_votes=true", "model.proposal_sampling=density",
     "eval.use_oriented_nms=true"],
    ["model.proposal_mode=lineage", "eval.use_3d_nms=false"],
], ids=["density_oriented_compact", "lineage_bev"])
def test_run_detector_outdoor_with_every_option(kitti_root, tmp_path,
                                                options):
    cfg = tconfig.parse_cli(_outdoor_args(
        kitti_root, "data.augment=true", "train.num_epochs=2",
        "train.eval_every=2", "train.log_every=1",
        f"train.ckpt_dir={tmp_path}", *options))
    result = run_detector(cfg, device="cpu")
    assert result.step == 2
    assert np.isfinite([h["loss"] for h in result.history]).all()
    (ev,) = result.evals
    assert np.isfinite(ev["val_loss"]) and 0.0 <= ev["mAP@0.25"] <= 1.0
    best = json.loads((tmp_path / "best.json").read_text())
    assert best == {"metric": ev["mAP@0.25"], "step": 2}
    again = run_detector(cfg, device="cpu")
    assert (again.start_step, again.step) == (2, 2)
    shutil.rmtree(tmp_path, ignore_errors=True)
