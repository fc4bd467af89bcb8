"""Data parallelism of the port (train_lib, train_detector, nn/norm.py,
losses.py over a ('data',) mesh) held against the JAX package's one-program
DP step (tests/distributed/test_dp.py) and against the port at world 1, on
the CPU.

The port's world-2 side runs on 2 gloo ranks started once for the file
(test_torch_parallel_workers.dp_ranks); world 1 and the JAX package run
here. The model is the tiny config of test_dp.py:17-31 and the batch its
8 scenes of 256 points, weights bridged from the JAX package's init.

Bounds, as test_dp.py states them: the loss at rtol 1e-5 (each of its
terms at rtol 1e-4, METRIC_RTOL); parameters after
one Adam step within 2e-2 (Adam's m/sqrt(v) amplifies summation-order
noise where a gradient is near zero; a wrong sum or a wrong denominator
moves them by O(1)); gradients within 1e-4 with BatchNorm on its running
statistics, as test_dp.py takes them. Gradients of a train-mode step
(BatchNorm's statistics over the data group, and their backward) are
~200 at most here, so they hold the port's bar for train steps
(tests/test_torch_train.py): per tensor, max |a - b| <= 1e-4 x its own
max |grad| + 1e-6 x the model's largest |grad|. The val sweep's metrics at
rtol 1e-5 (test_dp_eval.py:59-73); density-sampled proposal indices equal
(test_dp_density_sampling.py). The two ranks end every step with the same
parameters, bitwise.

k-step blocks (train.steps_per_call = k > 1) on the data group: a block
of k = 2 on stacked host batches against the JAX package's
make_detector_train_block on a 2-device mesh (the same bars: step 1's
loss at rtol 1e-5, step 2's at 1e-4, parameters within 2e-2), and bitwise
k DP steps on the same ranks; run_detector at k = 2 on the card's
synthetic feed and on the stacked host feed, 8 steps: step 1 against
world 1 at k = 2 (rtol 1e-5), the run bitwise the k = 1 run on the same
ranks (later steps drift from world 1 beyond rtol 1e-4, as world 1 with
its scenes reversed does: the test's docstring); resumes, one held to
world 1 over 4 steps at the bars of
test_run_detector_at_world_two_matches_world_one; run_classifier at
k = 4 bitwise k = 1 (the classifier has no block).
"""

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

from tpu3dsad import train_lib as jtrain
from tpu3dsad.config import Config as JConfig
from tpu3dsad.config import ModelConfig as JModelConfig
from tpu3dsad.config import TrainConfig as JTrainConfig
from tpu3dsad.config import apply_overrides as japply
from tpu3dsad.data.synthetic import classification_batch, detection_batch
from tpu3dsad.losses import detection_loss as jdetection_loss
from tpu3dsad.models.detector import SizeAdaptiveDetector as JDetector
from tpu3dsad.parallel import make_mesh as jmake_mesh
from tpu3dsad.parallel import replicated as jreplicated
from tpu3dsad.parallel import shard_batch as jshard_batch
from tpu3dsad_torch import train_lib
from tpu3dsad_torch.config import parse_cli
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.parallel import launch, make_mesh
from tpu3dsad_torch.parallel.mesh import AxisGroup
from tpu3dsad_torch.train_detector import run_detector
from tpu3dsad_torch.utils.bridge import state_dict_from_flax

import test_torch_parallel_workers as workers
from test_torch_detector import to_port

WORLD = 2
TINY = JModelConfig(
    num_classes=4,
    sa_npoints=(64, 32, 16, 8),
    sa_nsamples=(8, 8, 4, 4),
    sa_channels=((16, 16), (16, 32), (16, 32), (16, 32)),
    fp_channels=((32, 32), (32, 32)),
    seed_feat_dim=32,
    num_proposals=16,
    cluster_nsample=4,
)
JCFG = JConfig(model=TINY, train=JTrainConfig(batch_size=8))
DENSITY = japply(JConfig(model=dataclasses.replace(TINY, num_proposals=8)),
                 ["model.proposal_sampling=density",
                  "model.proposal_density_radius=0.5"])
LOSS_RTOL, PARAM_ATOL, GRAD_ATOL = 1e-5, 2e-2, 1e-4
# the loss's terms, each summed over the ranks' parts in another order;
# the smallest (~0.1 against a loss of ~50) carry ~1e-5 of rounding
METRIC_RTOL = 1e-4
# train.steps_per_call of the block and run_detector tests; the runs take
# 2 epochs of 4 steps (16 scenes a step), logging every 4
K = 2
K_RUN = dict(steps_per_call=K, num_epochs=2, eval_every=2, log_every=4)
# the blocks' BatchNorm momentum: epoch 25's, 0.75 (not a power of 2, and
# exact in fp32, as every value of the schedule is)
BLOCK_BN_M = train_lib.bn_momentum_at(to_port(JCFG).train, 25)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _init(model, batch):
    return _numpy_tree(jax.jit(lambda k: model.init(
        k, jnp.asarray(batch["points"]), mask=jnp.asarray(
            batch["point_mask"]), train=False))(jax.random.key(0)))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    batch = detection_batch(np.random.default_rng(0), 8, 256, 4,
                            max_boxes=8)
    jm = JDetector(TINY)
    jdensity = JDetector(DENSITY.model)
    host = [detection_batch(np.random.default_rng(i), 4, 64, 4, max_boxes=8)
            for i in range(3)]
    run_dir = tmp_path_factory.mktemp("run")
    blocks = [detection_batch(np.random.default_rng(10 + i), 8, 256, 4,
                              max_boxes=8) for i in range(K)]
    return {
        "cfg": to_port(JCFG), "variables": _init(jm, batch), "batch": batch,
        "jmodel": jm, "jdensity": jdensity,
        "sweep_cfg": dataclasses.replace(
            workers.tiny_config(), model=to_port(TINY),
            train=dataclasses.replace(workers.tiny_config().train,
                                      batch_size=8)),
        "density_cfg": to_port(DENSITY),
        "density_vars": _init(jdensity, batch),
        "cls_cfg": parse_cli(["preset=classifier", "model.num_classes=4",
                              "data.num_points=64", "train.batch_size=8"]),
        "cls_batch": classification_batch(np.random.default_rng(3), 8, 64,
                                          4),
        "plain": host,
        "stacked": [{k: np.stack([b[k], b[k]]) for k in b} for b in host],
        "run_cfg": dataclasses.replace(
            workers.tiny_config(str(run_dir / "world2")),
            model=to_port(TINY)),
        "run_dir": run_dir,
        "blocks": {k: np.stack([b[k] for b in blocks]) for k in blocks[0]},
        "block_bn_m": BLOCK_BN_M,
        "cls_run_cfg": parse_cli([
            "preset=classifier", "model.num_classes=4", "data.num_points=64",
            "train.batch_size=8", "train.num_epochs=1", "train.log_every=2",
            "train.mesh_shape=(2,)", "train.steps_per_call=4",
            f"train.ckpt_dir={run_dir / 'classifier'}"]),
        "k_cfg": _k_config(str(run_dir / "world2_k")),
        "k_host_cfg": _k_config(str(run_dir / "world2_host"), host=True),
    }


def _k_config(ckpt_dir: str, host: bool = False):
    """The tiny run at train.steps_per_call = K for 8 steps: on the card's
    synthetic feed (a val sweep after the last epoch), or host-fed
    (stacked [K, B, ...] blocks of the synthetic dataset, no sweep)."""
    cfg = dataclasses.replace(workers.tiny_config(ckpt_dir),
                              model=to_port(TINY))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             **K_RUN))
    if not host:
        return cfg
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, device_synth=False),
        train=dataclasses.replace(cfg.train, eval_every=K_RUN["num_epochs"]
                                  + 1))


def _in(cfg, ckpt_dir):
    """cfg with another checkpoint directory."""
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ckpt_dir=str(ckpt_dir)))


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    init = tmp_path_factory.mktemp("rendezvous") / "file"
    sent = {k: v for k, v in case.items()
            if k not in ("jmodel", "jdensity", "run_dir")}
    return launch.spawn(workers.dp_ranks, WORLD, backend="gloo",
                        init_file=str(init), args=(sent,))


@pytest.fixture(scope="module")
def world1(case):
    """The same scenarios at world 1, here (no process group)."""
    mesh = make_mesh()
    run_cfg = dataclasses.replace(case["run_cfg"], train=dataclasses.replace(
        case["run_cfg"].train, ckpt_dir=str(case["run_dir"] / "world1")))
    return {
        "step_train": workers.dp_step(case["cfg"], case["variables"],
                                      case["batch"], mesh, train_mode=True),
        "step_eval": workers.dp_step(case["cfg"], case["variables"],
                                     case["batch"], mesh, train_mode=False),
        "sweep": workers.dp_sweep(case["sweep_cfg"], case["variables"],
                                  mesh),
        "density": workers.dp_forward(case["density_cfg"],
                                      case["density_vars"],
                                      case["batch"]["points"],
                                      case["batch"]["point_mask"], mesh),
        "classifier": workers.dp_classifier(case["cls_cfg"],
                                            case["cls_batch"], mesh),
        "run": workers.dp_run(run_cfg),
        "run_k": workers.dp_run(_in(case["k_cfg"],
                                    case["run_dir"] / "world1_k")),
        "host_k": workers.dp_run(_in(case["k_host_cfg"],
                                     case["run_dir"] / "world1_host")),
    }


@pytest.fixture(scope="module")
def reference(case):
    """The JAX package's train step on the whole batch (test_dp.py), and
    the gradients with BatchNorm on its running statistics."""
    jm, var, batch = case["jmodel"], case["variables"], case["batch"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = jtrain.make_optimizer(JCFG.train, 10)
    state = jtrain.create_state(jm, lambda k: var, tx, jax.random.key(0))
    train_step, _ = jtrain.make_detector_steps(jm, JCFG)
    state, metrics = train_step(state, jb, jax.random.key(42), 0.9)

    def loss_fn(params):
        ep = jm.apply({"params": params, "batch_stats": var["batch_stats"]},
                      jb["points"], mask=jb["point_mask"], train=False)
        return jdetection_loss(ep, jb, jm._mean_sizes(),
                               TINY.num_heading_bins,
                               tuple(TINY.cluster_radius_bank))[0]

    grads = jax.jit(jax.grad(loss_fn))(var["params"])
    return {"loss": float(metrics["loss"]),
            "params": _numpy_tree({"params": state.params,
                                   "batch_stats": state.batch_stats}),
            "grads_eval": _numpy_tree({"params": grads})}


@pytest.fixture(scope="module")
def reference_block(case):
    """The JAX package's k-step block on a mesh of 2 of its devices, from
    the same variables: the state replicated, the stacked batches sharded
    on axis 1 (batch_axis_index=1), as its run_detector feeds a mesh."""
    jm, var = case["jmodel"], case["variables"]
    mesh = jmake_mesh((WORLD,), ("data",), devices=jax.devices()[:WORLD])
    tx = jtrain.make_optimizer(JCFG.train, 10)
    state = jax.device_put(
        jtrain.create_state(jm, lambda k: var, tx, jax.random.key(0)),
        jreplicated(mesh))
    blocks = jshard_batch({k: jnp.asarray(v) for k, v in
                           case["blocks"].items()}, mesh, batch_axis_index=1)
    block = jtrain.make_detector_train_block(jm, JCFG, K)
    state, metrics = block(state, blocks, jax.random.key(7), BLOCK_BN_M)
    return {"loss": np.asarray(metrics["loss"]), "count": int(state.step),
            "params": _numpy_tree({"params": state.params,
                                   "batch_stats": state.batch_stats})}


def _train_grads_close(got: dict, want: dict) -> None:
    gmax = max(float(np.abs(v).max()) for v in want.values())
    for k, v in want.items():
        err = float(np.abs(got[k] - v).max())
        assert err <= 1e-4 * float(np.abs(v).max()) + 1e-6 * gmax, (k, err)


def _worst(got: dict, want: dict) -> float:
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
               for k in want)


def _flax_to_port(tree, template):
    return {k: v.numpy() for k, v in state_dict_from_flax(
        tree, {k: torch.from_numpy(np.asarray(v))
               for k, v in template.items()}).items()}


# ------------------------------------------------------- the train step


def test_dp_step_matches_reference_train_step(ranks, reference):
    got = ranks[0]["step_train"]
    assert got["metrics"]["loss"] == pytest.approx(reference["loss"],
                                                   rel=LOSS_RTOL)
    want = _flax_to_port(reference["params"], got["state"])
    assert _worst(got["state"], want) < PARAM_ATOL


def test_dp_gradients_match_reference(ranks, reference):
    """BatchNorm on its running statistics, as test_dp.py:84-110 takes the
    gradients: the global denominators and the summed gradients."""
    got = ranks[0]["step_eval"]["grads"]
    want = _flax_to_port(reference["grads_eval"], got)
    assert _worst(got, want) < GRAD_ATOL


@pytest.mark.parametrize("mode", ["step_train", "step_eval"])
def test_dp_step_matches_world_one(ranks, world1, mode):
    """Train mode adds BatchNorm's statistics over the data group and their
    backward."""
    one = world1[mode]
    for r in ranks:
        got = r[mode]
        assert got["metrics"]["loss"] == pytest.approx(
            one["metrics"]["loss"], rel=LOSS_RTOL)
        for name, value in one["metrics"].items():
            assert got["metrics"][name] == pytest.approx(
                value, rel=METRIC_RTOL, abs=1e-7), name
        if mode == "step_eval":
            assert _worst(got["grads"], one["grads"]) < GRAD_ATOL
        else:
            _train_grads_close(got["grads"], one["grads"])
        assert _worst(got["state"], one["state"]) < PARAM_ATOL


@pytest.mark.parametrize("mode", ["step_train", "classifier"])
def test_dp_ranks_take_one_update(ranks, mode):
    for name, value in ranks[0][mode]["state"].items():
        np.testing.assert_array_equal(ranks[1][mode]["state"][name], value,
                                      err_msg=name)


def test_dp_classifier_step_matches_world_one(ranks, world1):
    """Dropout draws for the global batch, each rank keeping its rows."""
    one = world1["classifier"]
    for r in ranks:
        got = r["classifier"]
        assert got["metrics"]["loss"] == pytest.approx(
            one["metrics"]["loss"], rel=LOSS_RTOL)
        assert got["metrics"]["acc"] == one["metrics"]["acc"]
        _train_grads_close(got["grads"], one["grads"])
        assert _worst(got["state"], one["state"]) < PARAM_ATOL


# ---------------------------------------------------------- evaluation


def test_dp_sweep_matches_world_one(ranks, world1):
    one = world1["sweep"]
    for r in ranks:
        got = r["sweep"]
        assert set(got) == set(one)
        for k, v in one.items():
            if isinstance(v, dict):
                for c in v:
                    np.testing.assert_allclose(got[k][c], v[c], rtol=1e-5,
                                               err_msg=f"{k}/{c}")
            elif v is not None:
                np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


def test_dp_density_sampling_indices_equal(ranks, world1, case):
    rows = [r["density"] for r in ranks]
    got = {k: np.concatenate([r[k] for r in rows])
           for k in ("proposal_inds", "proposal_xyz")}
    np.testing.assert_array_equal(got["proposal_inds"],
                                  world1["density"]["proposal_inds"])
    np.testing.assert_array_equal(got["proposal_xyz"],
                                  world1["density"]["proposal_xyz"])
    b = case["batch"]
    ep = jax.jit(lambda p, m: case["jdensity"].apply(
        case["density_vars"], p, mask=m, train=False))(
            jnp.asarray(b["points"]), jnp.asarray(b["point_mask"]))
    np.testing.assert_array_equal(got["proposal_inds"],
                                  np.asarray(ep["proposal_inds"]))


# --------------------------------------------------------------- feeds


@pytest.mark.parametrize("stacked", [False, True], ids=["plain", "stacked"])
def test_device_prefetch_keeps_each_ranks_rows(ranks, case, stacked):
    """Axis 0 of a batch, axis 1 of a [k, B, ...] block."""
    host = case["stacked" if stacked else "plain"]
    key = "prefetch_stacked" if stacked else "prefetch"
    for rank, r in enumerate(ranks):
        assert len(r[key]) == len(host)
        for got, want in zip(r[key], host):
            for k, v in want.items():
                rows = v[:, 2 * rank:2 * rank + 2] if stacked else \
                    v[2 * rank:2 * rank + 2]
                np.testing.assert_array_equal(got[k], rows, err_msg=k)


def test_run_detector_at_world_two_matches_world_one(ranks, world1, case):
    """The device-synth run (4 steps of 16 scenes, then a val sweep): the
    synthetic batches are drawn whole on every rank and cut to its rows,
    so each step sees what world 1 sees. Step 1 starts from one state and
    holds the step's bound; later steps start from states 2e-2 apart at
    most (Adam near zero gradients), so they hold rtol 1e-4. Only rank 0
    writes checkpoints."""
    one = world1["run"]
    for r in ranks:
        got = r["run"]
        assert len(got["losses"]) == len(one["losses"]) == 4
        assert got["losses"][0] == pytest.approx(one["losses"][0],
                                                 rel=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-4)
        assert [e["step"] for e in got["evals"]] == [4]
        assert _worst(got["state"], one["state"]) < PARAM_ATOL
    for name, value in ranks[0]["run"]["state"].items():
        np.testing.assert_array_equal(ranks[1]["run"]["state"][name], value)
    assert sorted(p.name for p in (case["run_dir"] / "world2").iterdir()) \
        == ["best", "best.json", "ckpt_4.pt", "train_meta.json"]


def test_mesh_with_steps_per_call_is_refused(ranks, case, tmp_path):
    """No longer refused: at train.steps_per_call = 2 on the mesh of 2
    ranks the run completes on both, and its first epoch is bitwise the
    k = 1 run of the same config (test_run_detector_at_world_two_matches_
    world_one's run): the block runs its steps eagerly, the same ops in
    the same order. A mesh the world cannot hold still raises before any
    work, at k = 4 as at k = 1."""
    first = torch.load(case["run_dir"] / "world2_k" / "ckpt_4.pt",
                       weights_only=True)["model"]
    for r in ranks:
        got, one = r["k"]["run"], r["run"]
        assert got["step"] == 8 and np.isfinite(got["losses"]).all()
        np.testing.assert_array_equal(got["losses"][:4], one["losses"])
        for name, value in one["state"].items():
            np.testing.assert_array_equal(first[name].numpy(), value,
                                          err_msg=name)
    cfg = dataclasses.replace(
        workers.tiny_config(str(tmp_path / "ckpt")), model=to_port(TINY))
    for k in (4, 1):
        with pytest.raises(ValueError, match="holds 2 ranks"):
            run_detector(dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, mesh_shape=(2,), steps_per_call=k)), device="cpu")
    assert not (tmp_path / "ckpt").exists()


# ---------------------------------------------------- k-step blocks (DP)


def test_dp_block_matches_reference_block(ranks, reference_block):
    """A block of K steps on each rank's rows (axis 1) of the stacked
    batches against the JAX package's block on its 2-device mesh."""
    want = reference_block
    for r in ranks:
        got = r["block"]["block"]
        loss = got["metrics"]["loss"]
        assert loss.shape == (K,)
        assert loss[0] == pytest.approx(want["loss"][0], rel=LOSS_RTOL)
        np.testing.assert_allclose(loss, want["loss"], rtol=1e-4)
        assert _worst(got["state"], _flax_to_port(
            want["params"], got["state"])) < PARAM_ATOL
        assert got["count"] == want["count"] == K


def test_dp_block_is_bitwise_k_dp_steps(ranks):
    """The block equals K single DP steps on the same slices from the same
    state and generator: every step's metrics, the state and the count;
    and the two ranks hold one state."""
    for r in ranks:
        block, steps = r["block"]["block"], r["block"]["steps"]
        assert list(block["metrics"]) == list(steps["metrics"])
        for name, value in steps["metrics"].items():
            np.testing.assert_array_equal(block["metrics"][name], value,
                                          err_msg=name)
        for name, value in steps["state"].items():
            np.testing.assert_array_equal(block["state"][name], value,
                                          err_msg=name)
        assert block["count"] == steps["count"] == K
    for name, value in ranks[0]["block"]["block"]["state"].items():
        np.testing.assert_array_equal(
            ranks[1]["block"]["block"]["state"][name], value, err_msg=name)


@pytest.mark.parametrize("group", [None, 1, 2, "world2"])
def test_block_mode_follows_the_data_group(ranks, group):
    """The block's mode is fixed by its device and the optimizer's data
    group before any step: eager on the CPU whatever the group, eager for
    a group of more than one rank on any device (the reason names the
    group), a graph only on the card with no group or a group of one rank
    (the rule is asked of block_mode for a CUDA device here; chip_smoke.py
    phases 12 and 17 run it on the card)."""
    if group == "world2":
        assert [r["block"]["mode"] for r in ranks] == ["eager"] * WORLD
        return
    cfg = to_port(JCFG)
    model = SizeAdaptiveDetector(cfg.model, device="cpu")
    axis = None if group is None else AxisGroup(
        None, 0, group, tuple(range(group)))
    optimizer = train_lib.make_optimizer(cfg.train, 10, model.parameters(),
                                         axis)
    block = train_lib.make_detector_train_block(model, optimizer, cfg, K)
    assert block.mode == "eager" and block.graph is None
    assert block.why == ("data group of 2 ranks" if group == 2
                         else "on the cpu")
    on_card = train_lib.block_mode(torch.device("cuda"), axis, K)
    assert on_card == (
        ("eager", "data group of 2 ranks") if group == 2
        else ("graph", f"one step captured, replayed {K} times a call"))


@pytest.mark.parametrize("feed", ["device_synth", "host"])
def test_run_detector_k_at_world_two_matches_world_one(ranks, world1, feed):
    """run_detector at k = 2 for 8 steps, on the card's synthetic feed
    (each step's global batch drawn inside the block and cut to the
    rank's rows) and on the stacked host feed (one draw of k x B scenes a
    call, each rank's rows on axis 1). World 1 at k = 2 sees the same
    global batches: step 1, from one state, holds the step's bound. After
    it the states drift apart as fp32 sums in another order compound
    through Adam and the proposal picks, past rtol 1e-4 within 8 steps
    (chip_smoke.py phase 16 measures the same drift of world 1 with its
    scenes reversed; this file's 4-step run holds rtol 1e-4 on the
    device-synth feed). So
    the run is held bitwise to the k = 1 run of the same config on the
    same ranks, whose steps the tests above hold to world 1 one step at a
    time: the block runs the same eager DP steps in the same order."""
    key = {"device_synth": "run", "host": "host"}[feed]
    one = world1[key + "_k"]
    assert "train block: eager (on the cpu)" in one["stderr"]
    for r in ranks:
        got, eager = r["k"][key], r["k"][key + "_k1"]
        assert got["steps"] == one["steps"] == list(range(1, 9))
        assert got["count"] == one["count"] == 8
        assert np.isfinite(got["losses"]).all()
        assert got["losses"][0] == pytest.approx(one["losses"][0],
                                                 rel=LOSS_RTOL)
        assert got["losses"] == eager["losses"]
        for name, value in eager["state"].items():
            np.testing.assert_array_equal(got["state"][name], value,
                                          err_msg=name)
    for name, value in ranks[0]["k"][key]["state"].items():
        np.testing.assert_array_equal(ranks[1]["k"][key]["state"][name],
                                      value, err_msg=name)


@pytest.mark.parametrize("feed", ["device_synth", "host"])
def test_run_detector_k_logs_at_block_ends_and_rank_zero_writes(
        ranks, case, feed):
    """Log rows at steps 4 and 8 (tests/e2e/test_steps_per_call.py holds
    the reference's k = 2 run to them), printed by rank 0 alone with the
    block's mode on stderr; rank 0 alone writes the checkpoints of both
    epochs, train_meta.json and, after the sweep, the best snapshot."""
    key = {"device_synth": ("run", "world2_k"), "host": ("host",
                                                         "world2_host")}
    lead, other = (r["k"][key[feed][0]] for r in ranks)
    assert [row["step"] for row in lead["rows"]
            if "train/loss" in row] == [4, 8]
    assert other["rows"] == []
    assert "train block: eager (data group of 2 ranks)" in lead["stderr"]
    assert not any(line.startswith("train block") for line in
                   other["stderr"])
    ckpt = case["run_dir"] / key[feed][1]
    written = ["ckpt_4.pt", "ckpt_8.pt", "train_meta.json"]
    if feed == "device_synth":
        written = ["best", "best.json", *written]
        assert [e["step"] for e in lead["evals"]] == [8]
    assert sorted(p.name for p in ckpt.iterdir()) == written
    assert json.loads((ckpt / "train_meta.json").read_text()) == {
        "steps_per_epoch": 4, "steps_per_call": K}


@pytest.mark.parametrize("resume", ["nothing_left", "first_epoch"])
def test_run_detector_k_resumes_on_every_rank(ranks, case, tmp_path,
                                              resume):
    """Every rank reads the lead's checkpoint. From ckpt_8.pt, the end of
    the run, nothing is left to run and every rank holds the run's final
    state, bitwise. From ckpt_4.pt, the end of its first epoch, the ranks
    run steps 5-8 at k = 2 and are held to world 1 resumed from the same
    file (both runs draw their batches anew from the seed, as the JAX
    package's resume does), with the bars of the runs above."""
    if resume == "nothing_left":
        for r in ranks:
            got = r["k"]["again"]
            assert (got["start_step"], got["step"], got["steps"]) == (8, 8,
                                                                      [])
            for name, value in r["k"]["run"]["state"].items():
                np.testing.assert_array_equal(got["state"][name], value,
                                              err_msg=name)
        return
    shutil.copy(case["run_dir"] / "world2_k" / "ckpt_4.pt", tmp_path)
    one = workers.dp_run(_in(case["k_cfg"], tmp_path))
    assert (one["start_step"], one["steps"]) == (4, [5, 6, 7, 8])
    for r in ranks:
        got = r["k"]["resume"]
        assert (got["start_step"], got["step"], got["steps"],
                got["count"]) == (4, 8, [5, 6, 7, 8], 8)
        assert got["losses"][0] == pytest.approx(one["losses"][0],
                                                 rel=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-4)
        assert _worst(got["state"], one["state"]) < PARAM_ATOL
    assert [row["step"] for row in ranks[0]["k"]["resume"]["rows"]
            if "train/loss" in row] == [8]


def test_dp_classifier_run_ignores_steps_per_call(ranks):
    """run_classifier at train.mesh_shape=(2,) train.steps_per_call=4 runs
    on both ranks (it was refused) and is bitwise the steps_per_call=1
    run: the classifier runs one step a call, as the JAX package's does.
    Rank 0 alone writes its checkpoint."""
    for r in ranks:
        four, one = r["classifier_runs"][4], r["classifier_runs"][1]
        assert [h["step"] for h in four["history"]] == [1, 2, 3, 4]
        assert four["history"] == one["history"]
        for name, value in one["state"].items():
            np.testing.assert_array_equal(four["state"][name], value,
                                          err_msg=name)
        assert four["files"] == one["files"] == ["ckpt_4.pt"]
