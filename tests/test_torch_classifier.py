"""The classification slice of the PyTorch port (config #1) held against
the JAX package on the CPU, with the same numpy inputs and weights
carried across by utils/bridge.py: GroupAll, MLPHead and its dropout, the
SSG and MSG classifiers, one train step, the eval step, the shape writer,
the ModelNet converter and loader, and run_classifier.

Tolerances: integers (FPS picks, ball-query indices) and every file and
numpy batch are equal, bitwise. Floats agree at rtol 1e-4, atol 1e-5 (fp32
matmuls summed in another order): module outputs, logits, the loss, and
the parameters and BatchNorm statistics after one step, entry by entry;
the gradients tensor by tensor, max |port - JAX| <= rtol x max |JAX| +
atol, as tests/test_torch_train.py holds the detector's. A gradient entry
near 0 has no relative bar: BatchNorm over the head's B rows conditions
the backward badly, and both fp32 sides differ from a float64 run of the
port by up to ~7e-5 of each tensor's largest entry (the port the less).
Before the step's update, gradient entries below RESOLVE times the
comparison's bar are zeroed on both sides: Adam's first update is lr
times the sign of each entry, so an entry the comparison does not resolve
could move by 2 lr one way on one side and the other way on the other.
The train step runs at dropout 0 (the two RNGs differ, as in
tests/e2e/test_classifier.py); dropout is tested on its own.
"""

import copy
import filecmp
import inspect
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

import tpu3dsad.ops as jops
import tpu3dsad_torch.ops as tops
from tpu3dsad import presets as jpresets
from tpu3dsad import train_lib as jtrain
from tpu3dsad.config import parse_cli as jparse
from tpu3dsad.data import modelnet as jmodelnet
from tpu3dsad.data import preproc_modelnet as jpre
from tpu3dsad.data import synthetic_shapes as jshapes
from tpu3dsad.data.synthetic import classification_batch
from tpu3dsad.models.classifier import build_classifier as jbuild
from tpu3dsad.nn import GroupAll as JGroupAll
from tpu3dsad.nn import MLPHead as JMLPHead
from tpu3dsad_torch import eval_detector, presets, train_classifier, train_lib
from tpu3dsad_torch.data import get_dataset
from tpu3dsad_torch.data import modelnet as tmodelnet
from tpu3dsad_torch.data import preproc_modelnet as tpre
from tpu3dsad_torch.data import synthetic_shapes as tshapes
from tpu3dsad_torch.models.classifier import (
    PointNet2Classifier,
    build_classifier,
)
from tpu3dsad_torch.nn import GroupAll, MLPHead
from tpu3dsad_torch.nn.mlp import dropout
from tpu3dsad_torch.ops.cuda import ball_query as cuda_bq
from tpu3dsad_torch.ops.cuda import fps as cuda_fps
from tpu3dsad_torch.ops.cuda import scatter as cuda_scatter
from tpu3dsad_torch.train_classifier import run_classifier, run_eval_classifier
from tpu3dsad_torch.utils.bridge import (
    load_flax_variables,
    state_dict_from_flax,
)

from test_torch_detector import to_port
from test_torch_nn import randomize

RTOL, ATOL = 1e-4, 1e-5
RESOLVE = 10.0
B, N = 4, 128


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=msg)


def _cfgs(args):
    """(port Config, reference Config) of one command line."""
    ref = jparse(args)
    return to_port(ref), ref


# ----------------------------------------------------------- modules


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", ["no_mask", "mask", "all_masked"])
def test_group_all_matches_reference(case, train):
    """Output and (in training) the BatchNorm statistics; a cloud with no
    valid point pools to 0 on both sides."""
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-1, 1, (3, 40, 3)).astype(np.float32)
    feats = rng.normal(size=(3, 40, 5)).astype(np.float32)
    mask = None
    if case != "no_mask":
        mask = np.ones((3, 40), bool)
        mask[0, 25:] = False
        if case == "all_masked":
            mask[2] = False
    jm = JGroupAll(mlp=(16, 32))
    var = randomize(jm.init(jax.random.key(0), xyz, feats, mask=mask),
                    seed=3)
    out = jm.apply(var, xyz, feats, mask=mask, train=train, bn_momentum=0.7,
                   mutable=["batch_stats"] if train else False)
    want, stats = out if train else (out, None)
    tm = GroupAll((16, 32), in_features=5)
    load_flax_variables(tm, var)
    tm.train(train)
    got = tm(_t(xyz), _t(feats), mask=_t(mask), bn_momentum=0.7)
    assert got.shape == (3, 32)
    _close(got, want)
    if case == "all_masked":
        assert not got[2].any() and not np.asarray(want)[2].any()
    if train:
        ref = state_dict_from_flax(
            {"params": var["params"], **stats}, tm.state_dict())
        for key, value in ref.items():
            _close(tm.state_dict()[key], value, key)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_mlp_head_matches_reference(train):
    """Eval mode at dropout 0.5 (dropout off), train mode at dropout 0:
    logits and BatchNorm statistics."""
    p = 0.0 if train else 0.5
    x = np.random.default_rng(4).normal(size=(6, 24)).astype(np.float32)
    jm = JMLPHead(channels=(32, 16), num_out=5, dropout=p)
    var = randomize(jm.init(jax.random.key(1), x), seed=4)
    out = jm.apply(var, x, train=train, bn_momentum=0.6,
                   mutable=["batch_stats"] if train else False)
    want, stats = out if train else (out, None)
    tm = MLPHead(24, (32, 16), 5, dropout=p)
    assert sorted(tm.state_dict()) == sorted(state_dict_from_flax(
        var, tm.state_dict()))
    load_flax_variables(tm, var)
    tm.train(train)
    _close(tm(_t(x), bn_momentum=0.6), want)
    if train:
        ref = state_dict_from_flax({"params": var["params"], **stats},
                                   tm.state_dict())
        for key, value in ref.items():
            _close(tm.state_dict()[key], value, key)


def test_dropout_keeps_one_minus_p_scales_and_uses_only_its_generator():
    x = torch.rand(400, 500) + 0.5
    global_state = torch.get_rng_state()
    for p in (0.3, 0.5):
        y = dropout(x, p, torch.Generator().manual_seed(7))
        kept = y != 0
        assert abs(kept.float().mean().item() - (1 - p)) < 0.005
        assert torch.equal(y[kept], x[kept] / (1 - p))
        again = dropout(x, p, torch.Generator().manual_seed(7))
        assert torch.equal(y, again)  # same seed, same mask
        other = dropout(x, p, torch.Generator().manual_seed(8))
        assert not torch.equal(y, other)
    assert torch.equal(torch.get_rng_state(), global_state)
    assert dropout(x, 0.0, None) is x
    assert not dropout(x, 1.0, None).any()
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.5, None)

    head = MLPHead(500, (64,), 3, dropout=0.5)
    plain = MLPHead(500, (64,), 3, dropout=0.0)
    plain.load_state_dict(head.state_dict())
    head.eval(), plain.eval()
    assert torch.equal(head(x), plain(x))  # eval: dropout is the identity
    head.train()
    outs = [head(x, generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


# -------------------------------------------------------- classifier


def _batch(msg_seed=0):
    """B clouds of N points from classification_batch, the last with a
    padded tail."""
    b = classification_batch(np.random.default_rng(10 + msg_seed), B, N, 10)
    b["mask"][B - 1, 100:] = False
    b["points"][B - 1, 100:] = 40.0
    return b


def _pair(msg: bool):
    """(port cfg, ref cfg, jax model, flax variables, port model) at
    dropout 0 with the same random weights and BatchNorm statistics."""
    tcfg, jcfg = _cfgs(["preset=classifier", f"data.num_points={N}",
                        f"model.classifier_msg={msg}", "model.dropout=0"])
    jm = jbuild(jcfg, 10)
    b = _batch()
    var = randomize(jax.jit(lambda k: jm.init(
        k, b["points"], mask=b["mask"], train=False))(jax.random.key(0)),
        seed=5)
    tm = build_classifier(tcfg, 10, device="cpu")
    load_flax_variables(tm, var)
    return tcfg, jcfg, jm, var, tm


@pytest.fixture(scope="module", params=[False, True], ids=["ssg", "msg"])
def pair(request):
    return request.param, _pair(request.param)


def _recorded(monkeypatch):
    """Record the port's FPS and ball-query calls: {kind: [(args, kw,
    out)]}."""
    calls = {"fps": [], "ball_query": []}
    for kind, name in (("fps", "furthest_point_sample"),
                       ("ball_query", "ball_query")):
        fn = getattr(tops, name)

        def rec(*args, _fn=fn, _kind=kind, **kw):
            out = _fn(*args, **kw)
            calls[_kind].append((args, kw, out))
            return out
        monkeypatch.setattr(tops, name, rec)
    return calls


def test_classifier_forward_matches_reference(pair, monkeypatch):
    """FPS picks and ball-query indices equal at both SA levels (the SA
    inputs equal to the reference's too), logits within rtol/atol."""
    msg, (tcfg, jcfg, jm, var, tm) = pair
    b = _batch()
    want, inter = jax.jit(lambda v, p, m: jm.apply(
        v, p, mask=m, train=False, capture_intermediates=True))(
            var, b["points"], b["mask"])
    calls = _recorded(monkeypatch)
    with torch.no_grad():
        got = tm(_t(b["points"]), mask=_t(b["mask"]))
    _close(got, want)
    assert got.shape == (B, 10)
    assert len(calls["fps"]) == 2
    assert len(calls["ball_query"]) == (6 if msg else 2)
    levels = [inter["intermediates"][f"sa{i}"]["__call__"][0]
              for i in (1, 2)]
    for (args, _, picks), level in zip(calls["fps"], levels):
        np.testing.assert_array_equal(picks.numpy(), np.asarray(level[2]))
    radii = [(0.1, 0.2, 0.4), (0.2, 0.4, 0.8)] if msg else [(0.2,), (0.4,)]
    ks = [(16, 32, 128), (32, 64, 128)] if msg else [(32,), (64,)]
    sources = [b["points"], np.asarray(levels[0][0])]
    for j, (args, kw, (idx, cnt)) in enumerate(calls["ball_query"]):
        level, s = divmod(j, len(radii[0]))
        xyz, centers, r, k = args
        assert (r, k) == (radii[level][s], ks[level][s])
        np.testing.assert_array_equal(xyz.numpy(), sources[level])
        np.testing.assert_array_equal(centers.numpy(),
                                      np.asarray(levels[level][0]))
        mask = kw.get("mask")
        jidx, jcnt = jops.ball_query(
            jnp.asarray(xyz.numpy()), jnp.asarray(centers.numpy()), r, k,
            mask=None if mask is None else jnp.asarray(mask.numpy()))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def test_classifier_train_step_matches_reference(pair):
    """One classifier_train_step at dropout 0 from bridged weights against
    jax.value_and_grad of classifier_loss_fn and the reference's optax
    update: loss, accuracy, gradients, then the parameters and BatchNorm
    statistics after the update."""
    _, (tcfg, jcfg, jm, var, tm) = pair
    tm = copy.deepcopy(tm)
    b = _batch(1)
    bn_m = train_lib.bn_momentum_at(tcfg.train, 0)
    tx = jtrain.make_optimizer(jcfg.train, 100)

    @jax.jit
    def reference_step(variables, batch):
        params = variables["params"]
        (loss, (stats, metrics)), grads = jax.value_and_grad(
            lambda p: jtrain.classifier_loss_fn(
                jm, p, variables["batch_stats"], batch, jax.random.key(0),
                bn_m), has_aux=True)(params)
        resolved = jax.tree.map(
            lambda g: (jnp.abs(g) > RESOLVE * (RTOL * jnp.abs(g).max()
                                               + ATOL)).astype(jnp.float32),
            grads)
        updates, _ = tx.update(jax.tree.map(jnp.multiply, grads, resolved),
                               tx.init(params), params)
        return (loss, metrics, grads, resolved,
                {"params": optax.apply_updates(params, updates),
                 "batch_stats": stats})

    loss, metrics, grads, resolved, after = reference_step(var, b)

    optim = train_lib.make_optimizer(tcfg.train, 100, tm.parameters())
    named = dict(tm.named_parameters())
    keep = state_dict_from_flax({"params": resolved}, named)
    seen = {}
    for name, p in named.items():
        def hook(g, _name=name):
            seen[_name] = g.clone()
            return g * keep[_name]
        p.register_hook(hook)
    got = train_lib.classifier_train_step(
        tm, optim, {k: _t(v) for k, v in b.items()},
        torch.Generator().manual_seed(0), bn_m)
    assert set(got) == set(metrics) == {"loss", "acc"}
    _close(got["loss"], loss, "loss")
    assert got["acc"].item() == float(metrics["acc"])
    want_grads = state_dict_from_flax({"params": grads}, named)
    assert set(seen) == set(want_grads)
    for name, want in want_grads.items():
        err = (seen[name] - want).abs().max().item()
        assert err <= RTOL * want.abs().max().item() + ATOL, name
    resolved_share = (sum(k.sum().item() for k in keep.values())
                      / sum(k.numel() for k in keep.values()))
    assert resolved_share > 0.8
    want_state = state_dict_from_flax(after, tm.state_dict())
    for key, want in want_state.items():
        _close(tm.state_dict()[key], want, key)
    assert optim.count == 1


def test_classifier_eval_step_honours_the_scene_mask(pair):
    _, (tcfg, jcfg, jm, var, tm) = pair
    b = _batch(2)
    b["scene_mask"] = np.array([True, True, True, False])
    with torch.no_grad():
        b["labels"][:2] = tm.eval()(_t(b["points"][:2]),
                                    mask=_t(b["mask"][:2])).argmax(-1)
    state = jtrain.create_state(jm, lambda k: var,
                                jtrain.make_optimizer(jcfg.train, 100),
                                jax.random.key(0))
    want = jtrain.classifier_eval_step(
        jm, state, {k: jnp.asarray(v) for k, v in b.items()})
    got = train_lib.classifier_eval_step(tm, {k: _t(v) for k, v in b.items()})
    assert set(got) == set(want) == {"acc", "loss", "n_valid"}
    for key in got:
        _close(got[key], want[key], key)
    assert got["n_valid"].item() == 3 and got["acc"].item() >= 2 / 3
    del b["scene_mask"]
    whole = train_lib.classifier_eval_step(tm, {k: _t(v)
                                                for k, v in b.items()})
    assert whole["n_valid"].item() == 4


# ------------------------------------------- writer, converter, loader


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _same_files(a, b):
    names = _tree(a)
    assert names == _tree(b) and names
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, mismatch + errors


@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    """The reference's shape meshes (per_class=2, test_per_class=1) and
    the port's, written from one seed, and both converted to .npy by the
    port (num_points=256)."""
    root = tmp_path_factory.mktemp("shapes")
    counts = {
        "ref": jshapes.generate(str(root / "ref"), 2, 1, seed=4),
        "port": tshapes.generate(str(root / "port"), 2, 1, seed=4)}
    tpre.export_all(str(root / "port"), str(root / "npy"), num_points=256)
    return root, counts


def test_synthetic_shapes_writes_the_reference_bytes(shapes, tmp_path,
                                                     capsys):
    root, counts = shapes
    assert counts["ref"] == counts["port"] == {"train": 20, "test": 10}
    _same_files(root / "ref", root / "port")
    assert tshapes.SHAPE_CLASSES == jshapes.SHAPE_CLASSES
    for mod, out in ((tshapes, "a"), (jshapes, "b")):
        assert mod.main([f"out={tmp_path / out}", "per_class=1",
                         "test_per_class=1", "seed=9"]) == 0
        row = json.loads(capsys.readouterr().out)
        assert row["written"] == {"train": 10, "test": 10}
    _same_files(tmp_path / "a", tmp_path / "b")
    assert tshapes.main([]) == jshapes.main([]) == 2


def _resampled_root(root):
    """A modelnet40_normal_resampled-style tree: two classes, 6-column
    and 3-column text clouds, train and test lists."""
    rng = np.random.default_rng(6)
    names = ["night_stand", "chair"]
    (root).mkdir()
    (root / "modelnet40_shape_names.txt").write_text("\n".join(names) + "\n")
    items = {"train": ["night_stand_0001", "chair_0001", "chair_0002"],
             "test": ["night_stand_0002", "chair_0003"]}
    for split, listed in items.items():
        (root / f"modelnet40_{split}.txt").write_text("\n".join(listed))
        for i, name in enumerate(listed):
            cls = name.rsplit("_", 1)[0]
            (root / cls).mkdir(exist_ok=True)
            cols = 6 if i % 2 == 0 else 3
            pts = rng.normal(size=(50, cols))
            np.savetxt(root / cls / f"{name}.txt", pts, delimiter=",",
                       fmt="%.6f")


@pytest.mark.parametrize("layout", ["off", "resampled"])
def test_preproc_modelnet_writes_the_reference_bytes(shapes, tmp_path,
                                                     layout):
    if layout == "off":
        src = shapes[0] / "ref"
    else:
        src = tmp_path / "raw"
        _resampled_root(src)
    for max_items in (None, 1):
        outs = {}
        for name, mod in (("port", tpre), ("ref", jpre)):
            out = tmp_path / f"{name}_{max_items}"
            outs[name] = mod.export_all(str(src), str(out), num_points=300,
                                        max_items=max_items)
        assert outs["port"] == outs["ref"]
        assert outs["port"]["layout"] == layout
        _same_files(tmp_path / f"port_{max_items}",
                    tmp_path / f"ref_{max_items}")


def test_read_off_and_sampling_equal_reference(tmp_path):
    """A fused 'OFF<nv> <nf> 0' header and a quad face (fanned), then the
    area-weighted samples of one draw; a degenerate mesh resamples its
    vertices on both sides."""
    path = tmp_path / "quad.off"
    path.write_text("OFF4 2 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n"
                    "4 0 1 2 3\n3 0 1 3\n")
    tv, tf = tpre.read_off(str(path))
    jv, jf = jpre.read_off(str(path))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert tf.shape == (3, 3)
    flat = np.zeros_like(tv)
    for v in (tv, flat):
        np.testing.assert_array_equal(
            tpre.sample_mesh(v, tf, 97, np.random.default_rng(2)),
            jpre.sample_mesh(v, tf, 97, np.random.default_rng(2)))
    bad = tmp_path / "bad.off"
    bad.write_text("PLY\n")
    for mod in (tpre, jpre):
        with pytest.raises(ValueError, match="not an OFF file"):
            mod.read_off(str(bad))


@pytest.mark.parametrize("points", [64, 300], ids=["subsample", "repeat"])
def test_modelnet_dataset_batches_equal_reference(shapes, points):
    """Train batches (augmented) and val batches, bitwise, from one seed;
    300 points of 256 raw repeat points."""
    args = ["preset=classifier", "data.name=modelnet",
            f"data.root={shapes[0] / 'npy'}", f"data.num_points={points}"]
    tcfg, jcfg = _cfgs(args)
    tds, jds = get_dataset(tcfg, device="cpu"), jmodelnet.\
        ModelNetClassificationDataset(jcfg)
    assert isinstance(tds, tmodelnet.ModelNetClassificationDataset)
    assert (tds.num_classes, tds.steps_per_epoch(4)) == (
        jds.num_classes, jds.steps_per_epoch(4)) == (10, 5)
    for seed in (0, 1):
        t = tds.train_batch(np.random.default_rng(seed), 6)
        j = jds.train_batch(np.random.default_rng(seed), 6)
        assert t.keys() == j.keys()
        for k in t:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])
    tv = list(tds.val_batches(np.random.default_rng(3), 4))
    jv = list(jds.val_batches(np.random.default_rng(3), 4))
    assert len(tv) == len(jv) == 3  # 10 val items: the last batch padded
    for t, j in zip(tv, jv):
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])
    assert list(tv[-1]["scene_mask"]) == [True, True, False, False]


def test_classifier_preset_and_config_equal_reference():
    # every preset of the reference, and the port's own 3DSSD and
    # Group-Free 3D ones
    assert presets.PRESETS == {**jpresets.PRESETS,
                               "3dssd": presets.PRESETS["3dssd"],
                               "groupfree3d": presets.PRESETS["groupfree3d"]}
    tcfg, jcfg = _cfgs(["preset=classifier", "model.classifier_msg=true",
                        "model.dropout=0.3", "data.name=modelnet"])
    assert tcfg == to_port(jcfg)
    assert (tcfg.model.name, tcfg.data.num_points, tcfg.model.dropout) == (
        "classifier", 1024, 0.3)


# ------------------------------------------------------ run_classifier

# the keys of every JSON line of the reference's train.py::run_classifier
TRAIN_KEYS = {"step", "epoch", "loss", "acc"}
EPOCH_KEYS = {"epoch", "epoch_time_s", "clouds_per_sec"}
EVAL_KEYS = {"step", "eval/epoch", "eval/val_acc", "eval/val_loss",
             "eval/n_scenes"}


@pytest.mark.parametrize("source", ["modelnet", "synthetic"])
def test_run_classifier_on_cpu_logs_checkpoints_resumes_and_evaluates(
        shapes, tmp_path, capsys, source):
    """One tiny epoch (modelnet: 20 train items, 5 steps of 4; synthetic:
    the reference's 100 steps of 2 clouds), the reference's JSON lines,
    a checkpoint, a resume with no step, then run_eval_classifier and
    eval_detector.main on the checkpoint."""
    before = (cuda_fps.launches, cuda_bq.launches, cuda_scatter.launches)
    args = ["preset=classifier", "data.num_points=64",
            f"train.ckpt_dir={tmp_path}", "train.num_epochs=1",
            "train.eval_every=1"]
    if source == "modelnet":
        args += ["data.name=modelnet", f"data.root={shapes[0] / 'npy'}",
                 "train.batch_size=4", "train.log_every=2",
                 "model.classifier_msg=true"]
        steps, logged, val = 5, [2, 4], 10
    else:
        args += ["train.batch_size=2", "train.log_every=50",
                 "model.num_classes=4"]
        steps, logged, val = 100, [50, 100], 16
    cfg, _ = _cfgs(args)
    first = run_classifier(cfg, device="cpu")
    assert (first.start_step, first.step) == (0, steps)
    assert [h["step"] for h in first.history] == list(range(1, steps + 1))
    assert np.isfinite([h["loss"] for h in first.history]).all()
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [set(r) for r in rows] == [TRAIN_KEYS] * len(logged) + [
        EPOCH_KEYS, EVAL_KEYS]
    assert [r["step"] for r in rows[:len(logged)]] == logged
    (ev,) = first.evals
    assert ev["n_scenes"] == rows[-1]["eval/n_scenes"] == val
    assert 0.0 <= ev["val_acc"] <= 1.0 and np.isfinite(ev["val_loss"])
    assert (tmp_path / f"ckpt_{steps}.pt").exists()

    again = run_classifier(cfg, device="cpu")
    assert (again.start_step, again.step, again.history) == (steps, steps,
                                                             [])
    trained = first.model.state_dict()
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    capsys.readouterr()
    out = run_eval_classifier(cfg, device="cpu")
    assert set(out) == {"ckpt_step", "val_acc", "val_loss"}
    assert out["ckpt_step"] == steps and 0.0 <= out["val_acc"] <= 1.0
    assert json.loads(capsys.readouterr().out) == out
    assert (cuda_fps.launches, cuda_bq.launches,
            cuda_scatter.launches) == before  # the CPU took the plain ops


def _consumed(monkeypatch):
    """The numpy batches run_classifier hands its train and eval steps, in
    order: {"train": [...], "val": [...]}."""
    seen = {"train": [], "val": []}
    train_step = train_lib.classifier_train_step
    eval_step = train_lib.classifier_eval_step

    def host(batch):
        return {k: v.numpy() for k, v in batch.items()}

    def train(model, optimizer, batch, *args):
        seen["train"].append(host(batch))
        return train_step(model, optimizer, batch, *args)

    def evaluate(model, batch):
        seen["val"].append(host(batch))
        return eval_step(model, batch)

    monkeypatch.setattr(train_lib, "classifier_train_step", train)
    monkeypatch.setattr(train_lib, "classifier_eval_step", evaluate)
    return seen


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("source", ["synthetic", "modelnet"])
def test_run_classifier_consumes_the_reference_batch_stream(
        shapes, tmp_path, monkeypatch, source):
    """The reference draws one example batch from rng_np before its loop
    (train.py:69), so its step i trains on draw i + 1 and its val sweep
    draws after the last step. run_classifier's train and val batches are
    those draws, bitwise (synthetic: 2 steps, 2 val batches; modelnet: the
    5 steps of an epoch of 20 items, then the val clouds' subsets)."""
    args = ["preset=classifier", "train.batch_size=2", "data.num_points=64",
            f"train.ckpt_dir={tmp_path}", "train.num_epochs=1"]
    if source == "modelnet":
        args += ["data.name=modelnet", f"data.root={shapes[0] / 'npy'}",
                 "train.batch_size=4"]
    else:
        args += ["data.name=synthetic", "model.num_classes=4"]
        monkeypatch.setattr(train_classifier, "SYNTHETIC_STEPS_PER_EPOCH", 2)
        monkeypatch.setattr(train_classifier, "SYNTHETIC_VAL_BATCHES", 2)
    cfg, jcfg = _cfgs(args)
    seen = _consumed(monkeypatch)
    run_classifier(cfg, device="cpu")

    rng = np.random.default_rng(jcfg.train.seed)
    bs = jcfg.train.batch_size
    if source == "modelnet":
        ds = jmodelnet.ModelNetClassificationDataset(jcfg)
        steps = ds.steps_per_epoch(bs)
        draws = [ds.train_batch(rng, bs) for _ in range(1 + steps)]
        val = list(ds.val_batches(rng, bs))
    else:
        draws = [classification_batch(rng, bs, 64, 4) for _ in range(5)]
        val = draws[3:]
    _same_batches(seen["train"], draws[1:len(seen["train"]) + 1])
    assert len(seen["train"]) == (5 if source == "modelnet" else 2)
    _same_batches(seen["val"], val)


def test_classifier_entry_points_dispatch_and_refuse(monkeypatch, tmp_path):
    """eval_detector.main sends model.name=classifier to
    run_eval_classifier; train_classifier.main refuses the detector; a
    mesh larger than the process group (here none: a world of 1) is
    refused before any work."""
    seen = []
    monkeypatch.setattr(eval_detector, "run_eval_classifier",
                        lambda cfg: seen.append(cfg) or {})
    eval_detector.main(["preset=classifier", "train.ckpt_dir=/ckpt"])
    (cfg,) = seen
    assert (cfg.model.name, cfg.train.ckpt_dir) == ("classifier", "/ckpt")
    with pytest.raises(SystemExit, match="classifier"):
        train_classifier.main(["preset=scannet"])
    cfg, _ = _cfgs(["preset=classifier", f"train.ckpt_dir={tmp_path / 'c'}",
                    "train.mesh_shape=(2,)"])
    with pytest.raises(ValueError, match="holds 2 ranks"):
        run_classifier(cfg, device="cpu")
    assert not (tmp_path / "c").exists()


def test_classifier_entry_points_default_to_the_card(monkeypatch):
    for fn in (build_classifier, PointNet2Classifier.__init__,
               run_classifier, run_eval_classifier):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    cfg, _ = _cfgs(["preset=classifier", "data.num_points=64"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: build_classifier(cfg, 10),
                 lambda: run_classifier(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    moved = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(PointNet2Classifier, "to",
                        lambda self, device: moved.append(device) or self)
    build_classifier(cfg, 10)
    assert moved == [torch.device("cuda")]


def test_classifier_cli_runs_as_a_module(tmp_path):
    """python -m tpu3dsad_torch.train_classifier refuses a config that is
    not the classifier's, without JAX."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpu3dsad_torch.train_classifier",
         "model.name=detector"], capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and "preset=classifier" in proc.stderr
