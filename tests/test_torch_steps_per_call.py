"""k-step training blocks of the PyTorch port (train.steps_per_call = k > 1)
on the CPU: the block against k sequential port steps and against the JAX
package's make_detector_train_block (tests/e2e/test_steps_per_call.py holds
the reference to the same contract), run_detector driving it, resume, the
optimizer in tensor ops and BatchNorm with a tensor momentum.

Tolerances, with their reasons:

  * the port's block against k sequential port steps, and BatchNorm with a
    0-d tensor momentum against a float one: bitwise (the same ops in the
    same order; on the card chip_smoke.py phase 12 holds the CUDA-graph
    replay to eager steps);
  * the optimizer against optax on equal gradients: rtol 1e-6, atol 1e-7
    (fp32 rounding of the same formulas), as test_torch_train.py holds it;
  * the port's block against the reference's on the same 4 stacked
    batches from bridged weights, the bars of
    test_torch_train.py::test_train_steps_match_reference: losses rtol
    1e-5; parameters and BatchNorm statistics rtol 1e-4, atol 1e-6; the
    Adam moments, which sum the gradients, as that test holds gradients:
    per tensor, max |port - JAX| <= 1e-4 x its own max + 1e-6 x the
    largest over all tensors. The rate is 1e-7: Adam divides each gradient
    by its own running RMS, so a gradient entry that is rounding noise on
    both sides (the bias of a layer that feeds a train-mode BatchNorm)
    moves by up to +-lr differently on each side, and 4 such steps stay
    inside atol only at that rate; the moments take no rate.

The model is the tiny detector of tests/e2e/test_steps_per_call.py at 512
points, batch 2, k = 4.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

import tpu3dsad.ops as jops
from tpu3dsad import train_lib as jtrain
from tpu3dsad.config import Config, TrainConfig, apply_overrides
from tpu3dsad.data.registry import SyntheticDetectionDataset
from tpu3dsad.models.detector import SizeAdaptiveDetector as JDetector
from tpu3dsad_torch import ops, train_lib
from tpu3dsad_torch import train_detector as tdet
from tpu3dsad_torch.data.device_pipeline import synthetic_detection_batch
from tpu3dsad_torch.nn import MaskedBatchNorm
from tpu3dsad_torch.utils.bridge import (
    load_flax_variables,
    state_dict_from_flax,
)

from test_torch_detector import to_port

K = 4
TINY = [
    "model.name=detector", "data.name=synthetic", "data.num_points=512",
    "data.max_boxes=8", "model.num_classes=4",
    "model.sa_npoints=(128,64,32,16)", "model.sa_nsamples=(8,8,4,4)",
    "model.sa_channels=((16,16),(16,32),(16,32),(16,32))",
    "model.fp_channels=((32,32),(32,32))", "model.seed_feat_dim=32",
    "model.num_proposals=16", "model.cluster_nsample=4",
    "train.batch_size=2",
]


def _cfgs(*extra):
    """(reference Config, the port's) of the tiny detector."""
    ref = apply_overrides(Config(), [*TINY, *extra])
    return ref, to_port(ref)


def _host_batches(ref, seed=0):
    """K numpy batches of the reference's synthetic dataset."""
    ds = SyntheticDetectionDataset(ref)
    rng = np.random.default_rng(seed)
    return [ds.train_batch(rng, ref.train.batch_size) for _ in range(K)]


def _stack(batches):
    return {n: torch.from_numpy(np.stack([b[n] for b in batches]))
            for n in batches[0]}


@pytest.fixture
def exact_grouping():
    """Exact first-K grouping on both sides (the port always groups so)."""
    was = jops.get_fast_grouping(), ops.get_fast_grouping()
    jops.set_fast_grouping(False)
    ops.set_fast_grouping(False)
    yield
    jops.set_fast_grouping(was[0])
    ops.set_fast_grouping(was[1])


def _port(cfg, steps_per_epoch=100):
    model = tdet.build_detector(cfg, device="cpu")
    return model, train_lib.make_optimizer(cfg.train, steps_per_epoch,
                                           model.parameters())


def _assert_same_state(a, b):
    (ma, oa), (mb, ob) = a, b
    sb = mb.state_dict()
    for key, v in ma.state_dict().items():
        assert torch.equal(v, sb[key]), key
    for x, y in zip(oa.mu + oa.nu, ob.mu + ob.nu):
        assert torch.equal(x, y)
    assert torch.equal(oa.count, ob.count)


# ------------------------------------------- block == k sequential steps


@pytest.mark.parametrize("feed", ["host_augment", "device_synth"])
def test_block_is_bitwise_k_sequential_port_steps(exact_grouping, feed):
    """A block on 4 stacked host batches augmented in the step (draws from
    the step's generator), or on 4 batches its synth_fn makes (draws from
    the data generator), equals 4 single steps on the same batches from
    generators of the same seeds: parameters, BatchNorm statistics, Adam
    moments and count, and every step's metrics, bitwise."""
    extra = (["data.device_augment=true"] if feed == "host_augment"
             else ["data.device_synth=true"])
    ref, cfg = _cfgs(*extra)
    bn_m = train_lib.bn_momentum_at(cfg.train, 25)  # 0.75: not a power of 2
    runs = []
    for blocked in (True, False):
        model, optim = _port(cfg)
        step_gen = torch.Generator().manual_seed(1)
        data_gen = torch.Generator().manual_seed(2)

        def synth():
            return synthetic_detection_batch(
                data_gen, 2, 512, 4, 8, vote_candidates=3)

        batches = (_stack(_host_batches(ref)) if feed == "host_augment"
                   else None)
        if blocked:
            block = train_lib.make_detector_train_block(
                model, optim, cfg, K,
                synth_fn=synth if feed == "device_synth" else None,
                generators=(data_gen,))
            metrics = block(batches, step_gen, bn_m)
        else:
            step = train_lib.make_detector_steps(model, optim, cfg)
            rows = [step(synth() if batches is None else
                         {n: v[i] for n, v in batches.items()}, step_gen,
                         bn_m) for i in range(K)]
            metrics = {n: torch.stack([r[n] for r in rows]) for n in rows[0]}
        runs.append(((model, optim), metrics))
    (state_a, ma), (state_b, mb) = runs
    assert list(ma) == list(mb) and ma["loss"].shape == (K,)
    for n in ma:
        assert torch.equal(ma[n], mb[n]), n
    _assert_same_state(state_a, state_b)
    assert int(state_a[1].count) == K


# --------------------------------------------- the block vs the reference


def _opt_moments(state, name):
    """The `mu` or `nu` tree of an optax chain's Adam state."""
    for leaf in jax.tree.leaves(
            state, is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu")):
        if hasattr(leaf, name):
            return getattr(leaf, name)
    raise KeyError(name)


def test_block_matches_reference_block_on_stacked_batches(exact_grouping):
    """4 stacked host batches through the port's block and through the
    reference's make_detector_train_block, from the same variables: every
    step's loss, then the parameters, BatchNorm statistics, Adam moments
    and count after the block (tolerances in the module docstring)."""
    ref, cfg = _cfgs("train.lr=1e-7")
    raw = _host_batches(ref)
    stacked = {n: jnp.asarray(np.stack([b[n] for b in raw])) for n in raw[0]}
    jm = JDetector(ref.model)
    tx = jtrain.make_optimizer(ref.train, 100)
    state = jtrain.create_state(
        jm, lambda key: jm.init(key, stacked["points"][0],
                                mask=stacked["point_mask"][0], train=False),
        tx, jax.random.key(0))
    # host copies: the reference's block donates its state
    var = jax.tree.map(np.array, {"params": state.params,
                                  "batch_stats": state.batch_stats})
    bn_m = train_lib.bn_momentum_at(cfg.train, 0)
    jblock = jtrain.make_detector_train_block(jm, ref, K)
    jstate, jmetrics = jblock(state, stacked, jax.random.key(7),
                              float(jtrain.bn_momentum_at(ref.train, 0)))

    model, optim = _port(cfg)
    load_flax_variables(model, var)
    block = train_lib.make_detector_train_block(model, optim, cfg, K)
    metrics = block(_stack(raw), torch.Generator().manual_seed(7), bn_m)

    np.testing.assert_allclose(metrics["loss"].numpy(),
                               np.asarray(jmetrics["loss"]), rtol=1e-5)
    want = state_dict_from_flax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        model.state_dict())
    got = model.state_dict()
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    params = dict(model.named_parameters())
    for name, mine in (("mu", optim.mu), ("nu", optim.nu)):
        want = state_dict_from_flax(
            {"params": _opt_moments(jstate.opt_state, name)}, params)
        top = max(float(w.abs().max()) for w in want.values())
        for key, m in zip(params, mine):
            w = want[key]
            err = float((m - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()) + 1e-6 * top, (name,
                                                                     key)
    assert int(optim.count) == K == int(jstate.step)


# ----------------------------------------------------------- run_detector


def _run_cfg(tmp_path, *extra):
    _, cfg = _cfgs("data.device_synth=true", "train.batch_size=8",
                   "train.num_epochs=1", "train.eval_every=5",
                   "train.log_every=4", f"train.ckpt_dir={tmp_path}",
                   f"train.steps_per_call={K}", *extra)
    return cfg


def test_run_detector_device_synth_blocks_log_and_checkpoint(tmp_path,
                                                            capsys):
    """device_synth at k = 4: two blocks of 4 steps (64 scenes / 8), each
    made inside the block; finite losses, one history row a step, log rows
    at steps 4 and 8, the epoch's checkpoint and train_meta.json."""
    result = tdet.run_detector(_run_cfg(tmp_path), device="cpu")
    assert (result.start_step, result.step) == (0, 8)
    assert [h["step"] for h in result.history] == list(range(1, 9))
    assert np.isfinite([h["loss"] for h in result.history]).all()
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in rows if "train/loss" in r] == [4, 8]
    assert (tmp_path / "ckpt_8.pt").exists()
    assert json.loads((tmp_path / "train_meta.json").read_text()) == {
        "steps_per_epoch": 8, "steps_per_call": K}


def test_run_detector_resumes_under_k(tmp_path, capsys):
    """A k = 4 run resumes from its checkpoint at k = 4 (steps 8 -> 16,
    count 16), and a resume at k = 3, whose epochs round to 6 steps, warns
    that the schedules shift and keeps the recorded 8."""
    cfg = _run_cfg(tmp_path)
    first = tdet.run_detector(cfg, device="cpu")
    longer = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=2))
    more = tdet.run_detector(longer, device="cpu")
    assert (more.start_step, more.step, int(more.optimizer.count)) == (
        8, 16, 16)
    assert [h["step"] for h in more.history] == list(range(9, 17))
    assert not any(torch.equal(a, b) for a, b in zip(
        first.model.parameters(), more.model.parameters()))
    capsys.readouterr()
    three = dataclasses.replace(longer, train=dataclasses.replace(
        longer.train, steps_per_call=3, num_epochs=3))
    last = tdet.run_detector(three, device="cpu")
    assert (last.start_step, last.step) == (16, 22)  # epoch 16 // 6 = 2
    assert "used 8" in capsys.readouterr().err
    assert json.loads((tmp_path / "train_meta.json").read_text())[
        "steps_per_epoch"] == 8


# -------------------------------------------------------------- checkpoints


def test_checkpoint_of_torch_optim_layout_loads_in_place(tmp_path):
    """A checkpoint whose optimizer state is torch.optim.Adam's
    ({"inner": its state_dict, "count": int}, as written before the update
    moved into tensor ops) restores its moments and count into the
    optimizer's own tensors, whose addresses a captured graph holds; the
    optimizer's own layout round-trips the same way."""
    _, cfg = _cfgs()
    model, _ = _port(cfg)
    params = [p for p in model.parameters() if p.requires_grad]
    adam = torch.optim.Adam(params, lr=1e-3)
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        for p in params[1:]:  # the first never gets a gradient
            p.grad = torch.randn(p.shape, generator=gen)
        adam.step()
    torch.save({"model": model.state_dict(),
                "optimizer": {"inner": adam.state_dict(), "count": 2},
                "step": 2}, tmp_path / "ckpt_2.pt")

    fresh, optim = _port(cfg)
    addresses = [t.data_ptr() for t in optim.mu + optim.nu + [optim.count]]
    assert train_lib.restore_checkpoint(str(tmp_path), fresh, optim) == 2
    assert addresses == [t.data_ptr()
                         for t in optim.mu + optim.nu + [optim.count]]
    assert int(optim.count) == 2 and optim.count.dtype == torch.int64
    assert not optim.mu[0].any() and not optim.nu[0].any()
    for p, m, v in zip(params[1:], optim.mu[1:], optim.nu[1:]):
        assert torch.equal(m, adam.state[p]["exp_avg"])
        assert torch.equal(v, adam.state[p]["exp_avg_sq"])

    train_lib.save_checkpoint(str(tmp_path / "again"), fresh, optim, 2)
    other, again = _port(cfg)
    train_lib.restore_checkpoint(str(tmp_path / "again"), other, again)
    _assert_same_state((fresh, optim), (other, again))


# --------------------------------------------------- optimizer, BatchNorm


@pytest.mark.parametrize("opt", ["adam", "adamw_clip"])
def test_tensor_rate_optimizer_matches_optax_across_boundaries(opt):
    """Fed the same gradients for 6 updates on a schedule of 2 steps an
    epoch with boundaries after epochs 1 and 2, the optimizer moves the
    parameters and its moments as optax does; the rate it picks on the
    device from its count equals the host schedule at every count."""
    kw = {"adam": {}, "adamw_clip": dict(weight_decay=0.05, grad_clip=2.0)}
    ref = TrainConfig(lr=3e-3, lr_decay_steps=(1, 2),
                      lr_decay_rates=(0.3, 0.5), **kw[opt])
    rng = np.random.default_rng(5)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    tx = jtrain.make_optimizer(ref, 2)
    state = tx.init(params)
    tparams = [torch.from_numpy(params[k].copy()).requires_grad_(True)
               for k in ("a", "b")]
    optim = train_lib.make_optimizer(to_port(ref), 2, tparams)
    for count in range(8):
        want = np.float32(optim.schedule(count))
        assert optim.schedule(torch.tensor(count)).item() == want
        assert want == pytest.approx(float(jtrain.lr_schedule(ref, 2)(count)),
                                     rel=1e-6)
    jp = params
    for scale in (3.0, 1.0, 0.1, 2.0, 0.5, 1.0):
        grads = {k: (scale * rng.normal(size=v.shape)).astype(np.float32)
                 for k, v in params.items()}
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(tparams, ("a", "b")):
            p.grad = torch.from_numpy(grads[k])
        optim.step()
        for i, k in enumerate(("a", "b")):
            for got, want in ((tparams[i], jp[k]),
                              (optim.mu[i], _opt_moments(state, "mu")[k]),
                              (optim.nu[i], _opt_moments(state, "nu")[k])):
                np.testing.assert_allclose(got.detach().numpy(),
                                           np.asarray(want), rtol=1e-6,
                                           atol=1e-7, err_msg=k)
    assert int(optim.count) == 6


@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_tensor_momentum_is_bitwise_float_momentum(masked):
    """The running averages and the output of a train-mode call with a 0-d
    tensor momentum (what a captured graph reads) equal those with the
    same float, bitwise."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(2, 50, 7)).astype(np.float32))
    mask = torch.from_numpy(rng.random((2, 50)) < 0.7) if masked else None
    outs = []
    for momentum in (0.75, torch.tensor(0.75)):
        bn = MaskedBatchNorm(7).train()
        for _ in range(3):
            y = bn(x * 1.5 + 0.25, mask=mask, momentum=momentum)
        outs.append((y, bn.running_mean, bn.running_var))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
