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
"""

import dataclasses

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
from tpu3dsad_torch import train_lib
from tpu3dsad_torch.config import parse_cli
from tpu3dsad_torch.parallel import launch, make_mesh
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
    }


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


def test_mesh_with_steps_per_call_is_refused(ranks, tmp_path):
    """In a world of 2, and here, before any work: a k-step block is one
    CUDA graph, which cannot capture the collectives of a DP step."""
    for r in ranks:
        assert "steps_per_call=2" in r["refused"]
        assert "CUDA graph" in r["refused"]
    cfg = dataclasses.replace(
        workers.tiny_config(str(tmp_path / "ckpt")), model=to_port(TINY))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, mesh_shape=(2,), steps_per_call=4))
    with pytest.raises(NotImplementedError, match="steps_per_call=4"):
        run_detector(cfg, device="cpu")
    assert not (tmp_path / "ckpt").exists()
    with pytest.raises(ValueError, match="holds 2 ranks"):
        run_detector(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, steps_per_call=1)), device="cpu")
    assert train_lib.refuse_unported(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, mesh_shape=(-1,)))) is None
