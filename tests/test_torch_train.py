"""The detector-training slice of the PyTorch port held against the JAX
package on the CPU: the scatter backward, masked BatchNorm in training,
the losses, the on-card input pipeline, the schedules and optimizer, whole
train steps from bridged weights, and run_detector.

Tolerances, with their reasons:

  * the row scatter against the Pallas kernel (interpret mode) and the XLA
    scatter: rtol 1e-5, atol 1e-5 (fp32 sums in another order), the bar of
    tests/ops/test_pallas_scatter.py; out-of-range rows: exactly equal;
  * single ops and modules (gradients of gather / group /
    three_interpolate, BatchNorm, losses, augmentation): rtol 1e-5,
    atol 1e-6 (the same fp32 formulas, summed in another order);
  * whole train steps: loss rtol 1e-5; per parameter tensor, max |port -
    JAX| <= GRAD_RTOL x its own max |grad| + GRAD_ATOL x the model's
    largest |grad| (a fp32 backward through ~30 layers, summed in other
    orders; the second term covers gradients that are rounding noise on
    both sides: BatchNorm after a layer makes a per-channel shift of its
    input invisible, so e.g. the bias of a Dense feeding a train-mode
    BatchNorm has zero gradient in exact arithmetic). Updated parameters
    and BatchNorm statistics agree at rtol 1e-4, atol 1e-6, after two
    provisions. (1) Gradient entries below RESOLVE times that bar are
    zeroed on both sides before the update: Adam divides each gradient by
    its own running RMS, so an entry the comparison does not resolve to
    ~10% moves by up to +-lr differently on each side. (2) Each port step
    starts from the reference's parameters and statistics before it (the
    port's optimizer keeps its own moments and count across the three
    steps): free-running, a 1e-5 drift of the weights after two steps
    can move discrete choices (picks, nearest-GT assignments) of the
    third. A free-running run of the three steps stands beside it at
    looser bars (test_free_running_train_steps_stay_near_reference).

Integer outputs (FPS picks, ball-query indices, vote masks, bins) are
equal. The JAX side groups exactly (the port always does), as a reference
Config with ops_fast_grouping=False would.
"""

import dataclasses
import importlib
import inspect
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpu3dsad_torch.config as tconfig
from tpu3dsad import losses as jlosses
from tpu3dsad import train_lib as jtrain
from tpu3dsad.config import Config, DataConfig, ModelConfig, TrainConfig
from tpu3dsad.data import device_pipeline as jdp
from tpu3dsad.data.augment import AUG_PRESETS, resolve_aug
from tpu3dsad.data.synthetic import class_mean_sizes, detection_batch
from tpu3dsad.models.detector import SizeAdaptiveDetector as JDetector
from tpu3dsad.nn import MaskedBatchNorm as JBN
from tpu3dsad.ops.boxes import angle_to_bin as j_angle_to_bin
from tpu3dsad.ops.pallas.scatter import scatter_rows as pallas_scatter
from tpu3dsad.ops.xla.interpolate import three_interpolate as j_interp
from tpu3dsad_torch import losses as tlosses
from tpu3dsad_torch import ops, train_lib
from tpu3dsad_torch.data import device_pipeline as tdp
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.nn import MaskedBatchNorm
from tpu3dsad_torch.ops.boxes import angle_to_bin
from tpu3dsad_torch.ops.cuda import ball_query as cuda_bq
from tpu3dsad_torch.ops.cuda import fps as cuda_fps
from tpu3dsad_torch.ops.cuda import scatter as cuda_scatter
from tpu3dsad_torch.train_detector import run_detector
from tpu3dsad_torch.utils.bridge import (
    load_flax_variables,
    state_dict_from_flax,
)

from test_torch_detector import SMALL, to_port

jgroup = importlib.import_module("tpu3dsad.ops.xla.group")
RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# ------------------------------------------------------------ scatter


def _scatter_case(B, U, n, C):
    rng = np.random.default_rng(B * 100003 + U * 1009 + n * 31 + C)
    g = rng.standard_normal((B, U, C)).astype(np.float32)
    idx = rng.integers(0, n, (B, U)).astype(np.int32)
    idx[:, ::2] = rng.integers(0, min(8, n), (B, (U + 1) // 2))  # collisions
    return g, idx


@pytest.mark.parametrize("B,U,n,C", [
    (2, 512, 256, 131), (2, 256, 128, 259), (2, 512, 1024, 3),
    (1, 100, 70, 6), (3, 1000, 2000, 47), (2, 2048, 512, 64)])
def test_plain_scatter_matches_pallas_and_xla(B, U, n, C):
    g, idx = _scatter_case(B, U, n, C)
    got = ops.scatter_rows(_t(g), _t(idx), n).numpy()
    assert got.shape == (B, n, C) and got.dtype == np.float32
    _close(got, pallas_scatter(jnp.asarray(g), jnp.asarray(idx), n,
                               interpret=True), rtol=1e-5, atol=1e-5)
    _close(got, jgroup._scatter_rows(jnp.asarray(g), jnp.asarray(idx), n,
                                     mode="scatter"), rtol=1e-5, atol=1e-5)


def test_plain_scatter_drops_out_of_range_rows_like_pallas():
    """-1 and >= n add nothing, as in the Pallas kernel (the XLA CPU
    scatter would wrap -1 to n - 1, so it is not the reference here)."""
    g = np.arange(32, dtype=np.float32).reshape(1, 8, 4)
    idx = np.array([[0, -1, 3, 99999, 3, -1, 0, 2]], np.int32)
    got = ops.scatter_rows(_t(g), _t(idx), 8).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(pallas_scatter(jnp.asarray(g), jnp.asarray(idx), 8,
                                       interpret=True)))
    assert got[0, 7].sum() == 0


def test_cpu_backward_takes_plain_scatter():
    before = cuda_scatter.launches
    pts = torch.randn(2, 30, 5, requires_grad=True)
    ops.group(pts, torch.randint(0, 30, (2, 4, 3), dtype=torch.int32)
              ).sum().backward()
    assert pts.grad is not None and cuda_scatter.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_scatter.scatter_rows(torch.ones(1, 2, 3),
                                  torch.zeros(1, 2, dtype=torch.int32), 4)


@pytest.mark.parametrize("op", ["gather", "group", "three_interpolate"])
def test_gather_group_interpolate_grads_match_vjp(op):
    rng = np.random.default_rng(11)
    pts = rng.standard_normal((2, 40, 6)).astype(np.float32)
    if op == "gather":
        idx = rng.integers(0, 40, (2, 25)).astype(np.int32)
        jf, tf = jgroup.gather, ops.gather
        args = ()
    elif op == "group":
        idx = rng.integers(0, 40, (2, 9, 8)).astype(np.int32)
        idx[:, :, 4:] = idx[:, :, :1]  # pad slots repeat the first hit
        jf, tf = jgroup.group, ops.group
        args = ()
    else:
        idx = rng.integers(0, 40, (2, 30, 3)).astype(np.int32)
        w = rng.random((2, 30, 3)).astype(np.float32)
        jf, tf = j_interp, ops.three_interpolate
        args = (w,)
    out, vjp = jax.vjp(lambda p, *a: jf(p, jnp.asarray(idx), *a),
                       jnp.asarray(pts), *map(jnp.asarray, args))
    cot = rng.standard_normal(out.shape).astype(np.float32)
    want = vjp(jnp.asarray(cot))
    tp = _t(pts).requires_grad_(True)
    targs = [_t(a).requires_grad_(True) for a in args]
    got = tf(tp, _t(idx), *targs)
    _close(got, out)
    got.backward(_t(cot))
    for have, ref in zip([tp, *targs], want):
        _close(have.grad, ref)


# ---------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("case", ["no_mask", "masked", "all_masked"])
def test_masked_batchnorm_train_matches_flax(case):
    rng = np.random.default_rng(12)
    x = rng.normal(1.0, 2.0, (3, 7, 5)).astype(np.float32)
    mask = None
    if case == "masked":
        mask = rng.random((3, 7)) < 0.6
    elif case == "all_masked":
        mask = np.zeros((3, 7), bool)
    jbn = JBN()
    var = jbn.init(jax.random.key(0), jnp.asarray(x), train=False)
    var = {"params": {"scale": rng.normal(1, .3, 5).astype(np.float32),
                      "bias": rng.normal(0, .3, 5).astype(np.float32)},
           "batch_stats": {"mean": rng.normal(0, .5, 5).astype(np.float32),
                           "var": rng.uniform(.5, 2, 5).astype(np.float32)}}
    jmask = None if mask is None else jnp.asarray(mask)
    want, upd = jbn.apply(var, jnp.asarray(x), train=True, momentum=0.7,
                          mask=jmask, mutable=["batch_stats"])
    cot = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: jbn.apply(var, xx, train=True, momentum=0.7,
                                          mask=jmask,
                                          mutable=["batch_stats"])[0],
                     jnp.asarray(x))
    bn = MaskedBatchNorm(5).train()
    load_flax_variables(bn, var)
    tx = _t(x).requires_grad_(True)
    got = bn(tx, mask=_t(mask), momentum=0.7)
    _close(got, want, atol=1e-5)
    _close(bn.running_mean, upd["batch_stats"]["mean"])
    _close(bn.running_var, upd["batch_stats"]["var"])
    got.backward(_t(cot))
    _close(tx.grad, vjp(jnp.asarray(cot))[0], atol=1e-5)


# ------------------------------------------------------------- losses

NH, NC, BANK = 12, 4, (0.15, 0.3, 0.6)


def _loss_case(kind):
    """(end_points, batch) as numpy, B=3 scenes, N=64 points, S=16 seeds,
    P=12 proposals, G=5 GT slots (one padded)."""
    rng = np.random.default_rng(13)
    B, N, S, P, G = 3, 64, 16, 12, 5
    cls = rng.integers(0, NC, (B, G)).astype(np.int32)
    ms = class_mean_sizes(NC)
    gt_mask = np.ones((B, G), bool)
    gt_mask[:, -1] = False
    if kind == "no_gt":
        gt_mask[2] = False
    gt_centers = rng.uniform(-2, 2, (B, G, 3)).astype(np.float32)
    prop = rng.uniform(-2, 2, (B, P, 3)).astype(np.float32)
    prop[:, :4] = gt_centers[:, :4] + rng.normal(0, .1, (B, 4, 3))  # pos
    vt = rng.normal(0, .5, (B, N, 3)).astype(np.float32)
    if kind == "v3":  # slot 2 copies the primary: tied minima
        vt = np.stack([vt, vt + rng.normal(0, .3, vt.shape), vt], 2)
    ep = {
        "seed_inds": rng.integers(0, N, (B, S)).astype(np.int32),
        "seed_xyz": rng.uniform(-2, 2, (B, S, 3)),
        "seed_mask": rng.random((B, S)) < 0.9,
        "vote_xyz": rng.uniform(-2, 2, (B, S, 3)),
        "proposal_xyz": prop,
        "proposal_mask": rng.random((B, P)) < 0.9,
        "center": prop + rng.normal(0, .2, (B, P, 3)),
        "objectness_scores": rng.normal(size=(B, P, 2)),
        "heading_scores": rng.normal(size=(B, P, NH)),
        "heading_residuals_normalized": rng.normal(size=(B, P, NH)),
        "size_scores": rng.normal(size=(B, P, NC)),
        "size_residuals_normalized": rng.normal(size=(B, P, NC, 3)),
        "sem_cls_scores": rng.normal(size=(B, P, NC)),
        "scale_logits": rng.normal(size=(B, P, len(BANK))),
    }
    batch = {
        "vote_targets": vt,
        "vote_mask": rng.random((B, N)) < 0.7,
        "gt_centers": gt_centers,
        "gt_sizes": (ms[cls] * rng.uniform(.8, 1.25, (B, G, 3))),
        "gt_headings": rng.uniform(-np.pi, np.pi, (B, G)),
        "gt_classes": cls,
        "gt_mask": gt_mask,
    }
    if kind == "scene_mask":
        batch["scene_mask"] = np.array([True, False, True])
    cast = {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
            for k, v in {**ep, **batch}.items()}
    return {k: cast[k] for k in ep}, {k: cast[k] for k in batch}


FLOAT_KEYS = ("vote_xyz", "center", "objectness_scores", "heading_scores",
              "heading_residuals_normalized", "size_scores",
              "size_residuals_normalized", "sem_cls_scores", "scale_logits")


@pytest.mark.parametrize("kind", ["v1", "v3", "scene_mask", "no_gt"])
def test_detection_loss_matches_reference(kind):
    ep, batch = _loss_case(kind)
    ms = class_mean_sizes(NC)

    def jloss(floats):
        e = {**{k: jnp.asarray(v) for k, v in ep.items()}, **floats}
        return jlosses.detection_loss(
            e, {k: jnp.asarray(v) for k, v in batch.items()}, ms, NH, BANK)

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(ep[k]) for k in FLOAT_KEYS})
    tep = {k: _t(v) for k, v in ep.items()}
    for k in FLOAT_KEYS:
        tep[k].requires_grad_(True)
    total, got = tlosses.detection_loss(
        tep, {k: _t(v) for k, v in batch.items()}, ms, NH, BANK)
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], msg=name)
    assert float(got["pos_ratio"]) > 0  # the positive-proposal terms ran
    total.backward()
    for k in FLOAT_KEYS:
        # atol 1e-5: the jitted reference itself differs from eager JAX by
        # up to 3.7e-6 here (XLA folds the loss weights in another order)
        _close(tep[k].grad, jgrads[k], atol=1e-5, msg=k)


def test_angle_to_bin_matches_reference():
    angle = np.linspace(-7.0, 7.0, 301).astype(np.float32)
    b, r = angle_to_bin(_t(angle), NH)
    jb, jr = j_angle_to_bin(jnp.asarray(angle), NH)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))  # same fp32 ops


# --------------------------------------------------------- data on card


@pytest.mark.parametrize("V", [1, 3])
def test_expand_votes_matches_reference(V):
    rng = np.random.default_rng(14)
    B, N, G = 2, 300, 5
    centers = rng.uniform(-.4, .4, (B, G, 3)).astype(np.float32)  # overlap
    sizes = rng.uniform(.6, 1.2, (B, G, 3)).astype(np.float32)
    heads = rng.uniform(-np.pi, np.pi, (B, G)).astype(np.float32)
    valid = np.ones((B, G), bool)
    valid[1, 3:] = False
    pts = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    owner = rng.integers(-1, 3, (B, N)).astype(np.int32)
    args = (pts, owner, centers, sizes, heads, valid)
    jv, jm = jdp.expand_votes(*map(jnp.asarray, args), V)
    tv, tm = tdp.expand_votes(*map(_t, args), V)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tv.shape == jv.shape
    _close(tv, jv)
    if V > 1:  # some points really take a second box
        assert (tv[:, :, 1] != tv[:, :, 0]).any()
    # the compact-votes decoder builds the same from an owner field
    dec = tdp.decode_compact_votes(
        {"points": _t(pts), "vote_owner": _t(owner), "gt_centers": _t(centers),
         "gt_sizes": _t(sizes), "gt_headings": _t(heads),
         "gt_mask": _t(valid)}, V)
    assert "vote_owner" not in dec and torch.equal(dec["vote_targets"], tv)


@pytest.mark.parametrize("preset", ["scannet", "sunrgbd"])
def test_augment_batch_matches_reference_on_the_same_draws(preset):
    """The port draws with torch, the reference with jax.random; fed the
    reference's own draws, the port transforms the batch identically."""
    aug = AUG_PRESETS[preset]
    assert tdp.AUG_PRESETS == AUG_PRESETS
    assert tdp.resolve_aug(to_port(DataConfig()), preset) == \
        resolve_aug(DataConfig(), preset)
    nb = detection_batch(np.random.default_rng(15), 3, 200, 4, 8,
                         vote_candidates=3)
    key = jax.random.key(3)
    want = jdp.augment_batch({k: jnp.asarray(v) for k, v in nb.items()},
                             key, **aug)
    kfx, kfy, kr, ks = jax.random.split(key, 4)
    rot, scale = aug["rot_range"], aug["scale_range"]
    draws = {
        "flip_x": (_t(jax.random.bernoulli(kfx, 0.5, (3,)))
                   if aug["flip_x"] else None),
        "flip_y": (_t(jax.random.bernoulli(kfy, 0.5, (3,)))
                   if aug["flip_y"] else None),
        "angle": _t(jax.random.uniform(kr, (3,), minval=-rot, maxval=rot)),
        "scale": (None if scale is None else _t(jax.random.uniform(
            ks, (3, 1, 1), minval=scale[0], maxval=scale[1]))[:, 0, 0]),
    }
    got = tdp.apply_augment({k: _t(v) for k, v in nb.items()}, draws)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], atol=1e-5, msg=k)
    gen = torch.Generator().manual_seed(0)
    moved = tdp.augment_batch({k: _t(v) for k, v in nb.items()}, gen, **aug)
    assert not torch.equal(moved["points"], _t(nb["points"]))


@pytest.mark.parametrize("V", [1, 3])
def test_synthetic_detection_batch_invariants(V):
    gen = torch.Generator().manual_seed(V)
    B, N, NCL, MB = 4, 2000, 6, 10
    b = tdp.synthetic_detection_batch(gen, B, N, NCL, MB, vote_candidates=V)
    shapes = {"points": (B, N, 3), "point_mask": (B, N),
              "vote_targets": (B, N, 3) if V == 1 else (B, N, V, 3),
              "vote_mask": (B, N), "gt_centers": (B, MB, 3),
              "gt_sizes": (B, MB, 3), "gt_headings": (B, MB),
              "gt_classes": (B, MB), "gt_mask": (B, MB)}
    assert {k: tuple(v.shape) for k, v in b.items()} == shapes
    assert b["points"].dtype == torch.float32 and b["point_mask"].all()
    assert b["gt_classes"].dtype == torch.int32
    ngt = b["gt_mask"].sum(1)
    assert ((ngt >= 3) & (ngt <= 8)).all() and not b["gt_mask"][:, 8:].any()
    assert (b["gt_centers"][:, 8:] == 0).all()  # padding past max_objects
    # each voting point's primary target is its box's center, and the
    # point lies on that box's surface
    vt = b["vote_targets"] if V == 1 else b["vote_targets"][:, :, 0]
    ms = torch.as_tensor(class_mean_sizes(NCL))
    for s in range(B):
        m = b["vote_mask"][s]
        tgt = b["points"][s, m] + vt[s, m]
        d = (tgt[:, None] - b["gt_centers"][s, b["gt_mask"][s]][None]).norm(
            dim=-1)
        own = d.argmin(1)
        assert d.min(1).values.max() < 1e-5
        c, size = b["gt_centers"][s, own], b["gt_sizes"][s, own]
        h = b["gt_headings"][s, own]
        rel = b["points"][s, m] - c
        lx = torch.cos(h) * rel[:, 0] + torch.sin(h) * rel[:, 1]
        ly = -torch.sin(h) * rel[:, 0] + torch.cos(h) * rel[:, 1]
        local = torch.stack([lx, ly, rel[:, 2]], -1) / (size / 2)
        assert (local.abs().amax(-1) - 1).abs().max() < 1e-4
        cls = b["gt_classes"][s, b["gt_mask"][s]].long()
        ratio = b["gt_sizes"][s, b["gt_mask"][s]] / ms[cls]
        assert ((ratio > 0.8 - 1e-6) & (ratio < 1.25 + 1e-6)).all()
        # the other points are floor: in the room, at z ~ 0
        assert (b["points"][s, ~m, :2].abs() <= 2.0).all()
        assert b["points"][s, ~m, 2].abs().max() < 0.1


# --------------------------------------------------- schedules, config


def test_schedules_and_epoch_rounding_match_reference(tmp_path):
    ref = TrainConfig(lr=2e-3, lr_decay_steps=(1, 3, 3, 5),
                      lr_decay_rates=(0.5, 0.1, 0.2, 0.3),
                      bn_momentum_init=0.5, bn_decay_epochs=3,
                      bn_momentum_max=0.99)
    port = to_port(ref)
    j_lr, t_lr = jtrain.lr_schedule(ref, 4), train_lib.lr_schedule(port, 4)
    for count in range(30):
        assert t_lr(count) == pytest.approx(float(j_lr(count)), rel=1e-6)
    for epoch in range(40):
        assert train_lib.bn_momentum_at(port, epoch) == float(
            jtrain.bn_momentum_at(ref, epoch))
    for spe in (1, 3, 8, 64):
        for k in (1, 2, 4, 100):
            assert train_lib.round_steps_per_epoch(spe, k) == \
                jtrain.round_steps_per_epoch(spe, k)
    for mod, sub in ((jtrain, "j"), (train_lib, "t")):
        d = str(tmp_path / sub)
        assert mod.check_and_record_train_meta(d, 8, 1, resumed=False) is None
        warn = mod.check_and_record_train_meta(d, 4, 2, resumed=True)
        assert "steps_per_epoch=4" in warn and "used 8" in warn
        assert json.loads((tmp_path / sub / "train_meta.json").read_text()
                          )["steps_per_epoch"] == 8


@pytest.mark.parametrize("name", ["DataConfig", "TrainConfig", "Config"])
def test_training_config_defaults_equal_reference(name):
    port = getattr(tconfig, name)()
    ref = {"DataConfig": DataConfig, "TrainConfig": TrainConfig,
           "Config": Config}[name]()
    if name == "Config":
        assert to_port(ref) == port
        return
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("opt", ["adam", "adamw_clip"])
def test_optimizer_matches_optax_on_equal_gradients(opt):
    """Fed the same gradients, the port's optimizer moves the parameters as
    the reference's optax chain does, across an lr boundary and (for
    adamw_clip) with the clip engaged on steps 1-2 and idle on step 3.
    fp32 rounding of the same formulas: rtol 1e-6, atol 1e-7."""
    kw = {"adam": {}, "adamw_clip": dict(weight_decay=0.05, grad_clip=2.0)}
    ref = TrainConfig(lr=3e-3, lr_decay_steps=(1,), lr_decay_rates=(0.3,),
                      **kw[opt])
    rng = np.random.default_rng(17)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    tx = jtrain.make_optimizer(ref, 2)
    state = tx.init(params)
    tparams = [_t(params["a"]).requires_grad_(True),
               _t(params["b"]).requires_grad_(True)]
    optim = train_lib.make_optimizer(to_port(ref), 2, tparams)
    jp = params
    for scale in (3.0, 1.0, 0.1):
        grads = {k: (scale * rng.normal(size=v.shape)).astype(np.float32)
                 for k, v in params.items()}
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(tparams, ("a", "b")):
            p.grad = _t(grads[k])
        optim.step()
        for p, k in zip(tparams, ("a", "b")):
            _close(p, jp[k], rtol=1e-6, atol=1e-7, msg=k)
    assert optim.count == 3


# -------------------------------------------------- whole train steps

TRAIN_STEPS = 3
OPTIMIZERS = {
    "adam": dict(),
    "adamw_clip": dict(weight_decay=0.05, grad_clip=1.0),
}


def _train_cfg(**opt):
    """Reference Config of the step tests: SMALL model, an lr decay after
    the first epoch of 2 steps, so step 3 runs at the decayed rate."""
    return Config(model=SMALL, data=DataConfig(vote_candidates=3),
                  train=TrainConfig(lr=3e-3, lr_decay_steps=(1,),
                                    lr_decay_rates=(0.3,), **opt))


def _train_batches():
    rng = np.random.default_rng(16)
    out = []
    for _ in range(TRAIN_STEPS):
        b = detection_batch(rng, 2, 384, SMALL.num_classes, 8,
                            vote_candidates=3)
        b["point_mask"][1, 300:] = False  # a padded tail
        b["points"][1, 300:] = 30.0
        out.append(b)
    return out


GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
RESOLVE = 10.0


def _resolved(grads):
    """The flax tree of 0/1 masks of the gradient entries above the
    comparison's bar (module docstring)."""
    gmax = max(float(jnp.abs(g).max()) for g in jax.tree.leaves(grads))
    return jax.tree.map(
        lambda g: (jnp.abs(g) > RESOLVE * (GRAD_RTOL * jnp.abs(g).max()
                                           + GRAD_ATOL * gmax)
                   ).astype(jnp.float32), grads)


@pytest.fixture(scope="module")
def reference_runs():
    """{optimizer: (initial variables, [per step {loss, grads, resolved,
    params, batch_stats}])} from the JAX package's model, losses and
    optimizer; unresolved gradient entries are zeroed before each update
    (`_resolved`)."""
    cfg = _train_cfg()
    jm = JDetector(SMALL)
    batches = _train_batches()
    var = jax.jit(lambda k: jm.init(
        k, jnp.asarray(batches[0]["points"]),
        mask=jnp.asarray(batches[0]["point_mask"]), train=False))(
            jax.random.key(0))
    ms = class_mean_sizes(SMALL.num_classes)
    bn_m = float(jtrain.bn_momentum_at(cfg.train, 0))
    @jax.jit
    def loss_and_grad(params, stats, batch):
        def lf(p):
            ep, upd = jm.apply({"params": p, "batch_stats": stats},
                               batch["points"], mask=batch["point_mask"],
                               train=True, bn_momentum=bn_m,
                               mutable=["batch_stats"])
            loss, _ = jlosses.detection_loss(
                ep, batch, ms, SMALL.num_heading_bins,
                tuple(SMALL.cluster_radius_bank))
            return loss, upd["batch_stats"]
        return jax.value_and_grad(lf, has_aux=True)(params)

    runs = {}
    for name, opt in OPTIMIZERS.items():
        tx = jtrain.make_optimizer(_train_cfg(**opt).train, 2)
        params, stats = var["params"], var["batch_stats"]
        state = tx.init(params)
        steps = []
        for b in batches:
            (loss, stats), grads = loss_and_grad(
                params, stats, {k: jnp.asarray(v) for k, v in b.items()})
            resolved = _resolved(grads)
            used = jax.tree.map(jnp.multiply, grads, resolved)
            updates, state = tx.update(used, state, params)
            params = optax.apply_updates(params, updates)
            steps.append({"loss": float(loss), "grads": grads,
                          "resolved": resolved, "params": params,
                          "batch_stats": stats})
        runs[name] = (var, steps)
    return runs


@pytest.fixture(scope="module")
def port_runs(reference_runs):
    """The same steps through the port. Each step starts from the
    reference's parameters and BatchNorm statistics before it (the port's
    optimizer keeps its own state across the steps) and zeroes the same
    gradient entries."""
    runs = {}
    for name, opt in OPTIMIZERS.items():
        var, ref_steps = reference_runs[name]
        cfg = to_port(_train_cfg(**opt))
        model = SizeAdaptiveDetector(cfg.model, device="cpu")
        optim = train_lib.make_optimizer(cfg.train, 2, model.parameters())
        params = dict(model.named_parameters())
        bn_m = train_lib.bn_momentum_at(cfg.train, 0)
        steps = []
        for b, ref in zip(_train_batches(), ref_steps):
            load_flax_variables(model, var)
            model.train()
            optim.zero_grad()
            loss, _ = train_lib.detector_loss(
                model, cfg, {k: _t(v) for k, v in b.items()}, bn_m)
            loss.backward()
            grads = {n: p.grad.clone() for n, p in params.items()}
            keep = state_dict_from_flax({"params": ref["resolved"]}, params)
            for n, p in params.items():
                p.grad *= keep[n]
            optim.step()
            steps.append({"loss": loss.item(), "grads": grads,
                          "state": {k: v.clone() for k, v in
                                    model.state_dict().items()}})
            var = {"params": ref["params"], "batch_stats": ref["batch_stats"]}
        assert optim.count == TRAIN_STEPS
        runs[name] = (model, steps)
    return runs


@pytest.mark.parametrize("step", [1, TRAIN_STEPS])
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_train_steps_match_reference(reference_runs, port_runs, opt, step):
    _, jsteps = reference_runs[opt]
    model, tsteps = port_runs[opt]
    js, ts = jsteps[step - 1], tsteps[step - 1]
    assert ts["loss"] == pytest.approx(js["loss"], rel=1e-5)
    jg = state_dict_from_flax({"params": js["grads"]},
                              dict(model.named_parameters()))
    gmax = max(g.abs().max().item() for g in jg.values())
    for name, want in jg.items():
        err = (ts["grads"][name] - want).abs().max().item()
        assert err <= GRAD_RTOL * want.abs().max().item() + GRAD_ATOL * gmax, \
            name
    want_state = state_dict_from_flax(
        {"params": js["params"], "batch_stats": js["batch_stats"]},
        model.state_dict())
    for key, want in want_state.items():
        _close(ts["state"][key], want, rtol=1e-4, atol=1e-6, msg=key)


@pytest.fixture(scope="module")
def free_port_runs(reference_runs):
    """The port's three steps chained on its own state from the bridged
    initial variables, never reloaded; the same gradient entries are
    zeroed as in the reference."""
    runs = {}
    for name, opt in OPTIMIZERS.items():
        var, ref_steps = reference_runs[name]
        cfg = to_port(_train_cfg(**opt))
        model = SizeAdaptiveDetector(cfg.model, device="cpu")
        load_flax_variables(model, var)
        optim = train_lib.make_optimizer(cfg.train, 2, model.parameters())
        params = dict(model.named_parameters())
        bn_m = train_lib.bn_momentum_at(cfg.train, 0)
        losses = []
        for b, ref in zip(_train_batches(), ref_steps):
            model.train()
            optim.zero_grad()
            loss, _ = train_lib.detector_loss(
                model, cfg, {k: _t(v) for k, v in b.items()}, bn_m)
            loss.backward()
            keep = state_dict_from_flax({"params": ref["resolved"]}, params)
            for n, p in params.items():
                p.grad *= keep[n]
            optim.step()
            losses.append(loss.item())
        runs[name] = (model, losses)
    return runs


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_free_running_train_steps_stay_near_reference(
        reference_runs, free_port_runs, port_runs, opt):
    """Three port steps on the port's own state, against the reference's
    three. Drift may flip discrete picks on the vote cloud (module
    docstring), so the bars are looser and stated: every step's loss
    within rel 1e-4, every BatchNorm running mean and variance within
    rtol 1e-3, atol 1e-5, and every parameter within lr / 2 of the
    reference's (Adam moves each entry by up to ~lr a step, so a wrong
    update of any entry shows)."""
    _, jsteps = reference_runs[opt]
    model, losses = free_port_runs[opt]
    _, reseeded = port_runs[opt]
    for step, (got, js) in enumerate(zip(losses, jsteps), 1):
        assert got == pytest.approx(js["loss"], rel=1e-4), step
    assert losses[0] == reseeded[0]["loss"]  # step 1 starts from one state
    lr = _train_cfg(**OPTIMIZERS[opt]).train.lr
    state = model.state_dict()
    want = state_dict_from_flax(
        {"params": jsteps[-1]["params"],
         "batch_stats": jsteps[-1]["batch_stats"]}, state)
    for key, w in want.items():
        if "running" in key:
            _close(state[key], w, rtol=1e-3, atol=1e-5, msg=key)
        else:
            assert (state[key] - w).abs().max().item() <= lr / 2, key


# ---------------------------------------------------------- run_detector


def _run_cfg(tmp_path, **train):
    ref = Config(model=SMALL,
                 data=DataConfig(name="synthetic", device_synth=True,
                                 num_points=512, max_boxes=8),
                 train=TrainConfig(batch_size=8, num_epochs=1, eval_every=5,
                                   log_every=4, ckpt_dir=str(tmp_path),
                                   **train))
    return to_port(ref)


def test_run_detector_on_cpu_trains_logs_checkpoints_and_resumes(
        tmp_path, capsys):
    before = (cuda_fps.launches, cuda_bq.launches, cuda_scatter.launches)
    cfg = _run_cfg(tmp_path)
    first = run_detector(cfg, device="cpu")
    assert (first.start_step, first.step) == (0, 8)  # 64 // 8 steps
    assert np.isfinite([h["loss"] for h in first.history]).all()
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in rows if "step" in r] == [4, 8]
    assert all(r["train/epoch"] == 0 and "train/vote_loss" in r
               for r in rows if "step" in r)
    assert [r["epoch"] for r in rows if "epoch_time_s" in r] == [0]
    assert (tmp_path / "ckpt_8.pt").exists()
    assert (cuda_fps.launches, cuda_bq.launches,
            cuda_scatter.launches) == before  # the CPU took the plain ops

    again = run_detector(cfg, device="cpu")
    assert (again.start_step, again.step, again.history) == (8, 8, [])
    trained = first.model.state_dict()
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, trained[k]), k

    longer = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=2))
    more = run_detector(longer, device="cpu")
    assert (more.start_step, more.step) == (8, 16)
    assert more.optimizer.count == 16
    assert sorted(p.name for p in tmp_path.glob("ckpt_*.pt")) == [
        "ckpt_16.pt", "ckpt_8.pt"]


@pytest.mark.parametrize("change,match", [
    (dict(train=dict(eval_every=1)), "A7"),
    (dict(data=dict(device_synth=False)), "A7"),
    (dict(train=dict(steps_per_call=4)), "A7"),
    (dict(train=dict(mesh_shape=(2,))), "A11"),
    (dict(data=dict(name="scannet")), "A7"),
], ids=["evaluate", "host_fed", "steps_per_call", "mesh", "dataset"])
def test_run_detector_refuses_unported_paths(tmp_path, change, match):
    cfg = _run_cfg(tmp_path)
    cfg = dataclasses.replace(cfg, **{
        sec: dataclasses.replace(getattr(cfg, sec), **kw)
        for sec, kw in change.items()})
    with pytest.raises(NotImplementedError, match=match):
        run_detector(cfg, device="cpu")
    assert not list(tmp_path.iterdir())  # refused before any work


def test_entry_points_default_to_the_card(monkeypatch):
    for fn in (SizeAdaptiveDetector.__init__, run_detector):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SizeAdaptiveDetector(to_port(SMALL))
    moved = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(SizeAdaptiveDetector, "to",
                        lambda self, device: moved.append(device) or self)
    SizeAdaptiveDetector(to_port(SMALL))
    assert moved == [torch.device("cuda")]


def test_training_modules_import_without_jax():
    code = (
        "import sys\n"
        "import tpu3dsad_torch.train_detector, tpu3dsad_torch.train_lib\n"
        "import tpu3dsad_torch.losses, tpu3dsad_torch.data\n"
        "import tpu3dsad_torch.data.device_pipeline\n"
        "import tpu3dsad_torch.utils.metrics, tpu3dsad_torch.ops\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'tpu3dsad')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
