"""chip_recipes.py, the port's full-length training runs held to the
reference's committed learning curves (docs/experiments/), on the CPU:

  * each recipe's command line parses to the reference's config, field by
    field, but the port's documented ops_fast_grouping default;
  * at each recipe's own epoch length and steps_per_call, the learning
    rate and BatchNorm momentum equal the reference's at every epoch
    boundary, resumes and decays included (fp32 rates: rel 1e-6, as
    test_torch_train.py holds them; momenta exactly);
  * each recipe's epoch length is the one its reference log ran;
  * compare_curves on small hand-made logs: a pass, a miss on each
    metric, a missing eval epoch;
  * the committed docs/torch_experiments/*.jsonl cover every eval epoch
    of their reference and give the verdicts of summary.json;
  * the script imports neither JAX nor the JAX package, and refuses to
    train where torch.cuda finds no device.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import chip_recipes as cr  # noqa: E402
import tpu3dsad_torch.config as tconfig  # noqa: E402
from test_torch_detector import PORT_ONLY  # noqa: E402
from tpu3dsad import config as jconfig  # noqa: E402
from tpu3dsad import train_lib as jtrain  # noqa: E402
from tpu3dsad_torch import train_lib  # noqa: E402

LEGS = [(key, leg, seed) for key, r in cr.RECIPES.items()
        for leg in range(len(r.legs)) for seed in ((0, 1) if key == "R1"
                                                   else (0,))]
# the scenes a train epoch draws from: R1's synthetic stream is 64 scenes
# an epoch; R2 and R3 the train splits of the writers' defaults
SCENES = {"R1": 64, "R2": 256, "R3": 48}


@pytest.mark.parametrize("key,leg,seed", LEGS)
def test_recipe_argv_parses_as_reference(key, leg, seed):
    """Every field of every section and every top-level field equal, but
    ops_fast_grouping: False in the port, True in the reference (whose
    default fast tier, lax.approx_max_k, is the TPU's), and 3DSSD's
    ssd3d_* fields, which the port alone has."""
    argv = cr.leg_argv(cr.RECIPES[key], leg, "/data/scenes", "/ckpt", seed)
    port, ref = tconfig.parse_cli(argv), jconfig.parse_cli(argv)
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(got):
            for g in dataclasses.fields(got):
                if g.name in PORT_ONLY:
                    continue
                assert getattr(got, g.name) == getattr(want, g.name), (
                    f.name, g.name)
        elif f.name == "ops_fast_grouping":
            assert (got, want) == (False, True)
        else:
            assert got == want, f.name
    assert port.train.seed == seed
    assert port.train.num_epochs == cr.RECIPES[key].epochs(leg)


@pytest.mark.parametrize("key", sorted(cr.RECIPES))
def test_recipe_epoch_length_is_the_reference_logs(key):
    """Both packages round the recipe's epoch to the same steps at its k,
    and every eval line of the reference log sits at (epoch + 1) x that
    length."""
    recipe = cr.RECIPES[key]
    cfg = tconfig.parse_cli(cr.leg_argv(recipe, 0, "", "/ckpt", 0))
    spe = SCENES[key] // cfg.train.batch_size
    got = train_lib.round_steps_per_epoch(spe, cfg.train.steps_per_call)
    assert got == jtrain.round_steps_per_epoch(spe, cfg.train.steps_per_call)
    assert got == (recipe.steps_per_epoch, recipe.k)
    ref = cr.read_jsonl(cr.REFERENCE_DIR / recipe.reference)
    evals = cr.evals_by_epoch(ref)
    assert evals and all(r["step"] == (e + 1) * recipe.steps_per_epoch
                         for e, r in evals.items())
    assert max(r["step"] for r in ref if "step" in r) == recipe.steps


@pytest.mark.parametrize("key,leg", [(k, g) for k, g, s in LEGS if s == 0])
def test_schedules_match_reference_at_recipe_scale(key, leg):
    """The lr (int and 0-d tensor counts) at each epoch boundary of the
    leg and one step either side, and the BN momentum of every epoch the
    leg runs, equal the reference's. R3's legs resume at epochs 300 and
    1200 and decay at 450, 750 and 1000."""
    recipe = cr.RECIPES[key]
    argv = cr.leg_argv(recipe, leg, "", "/ckpt", 0)
    port, ref = tconfig.parse_cli(argv), jconfig.parse_cli(argv)
    spe = recipe.steps_per_epoch
    first = recipe.epochs(leg - 1) if leg else 0
    last = recipe.epochs(leg)
    counts = sorted({c for e in range(first, last + 1)
                     for c in (e * spe - 1, e * spe, e * spe + 1)
                     if 0 <= c <= last * spe})
    want = np.asarray(jtrain.lr_schedule(ref.train, spe)(np.asarray(counts)))
    t_lr = train_lib.lr_schedule(port.train, spe)
    got = [t_lr(c) for c in counts]
    got_t = [float(t_lr(torch.tensor(c))) for c in counts]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got_t, want, rtol=1e-6)
    levels = {round(float(v), 9) for v in want}
    decays = [e for e in port.train.lr_decay_steps if first < e <= last]
    assert len(levels) == 1 + len(decays)
    for epoch in range(first, last):
        assert train_lib.bn_momentum_at(port.train, epoch) == float(
            jtrain.bn_momentum_at(ref.train, epoch)), epoch


def _log(evals, losses=(10.0, 9.0, 8.0)):
    """A hand-made log: train lines, then one eval line per
    (epoch, mAP@0.25, mAP@0.5)."""
    lines = [{"step": i + 1, "train/epoch": 0, "train/loss": v}
             for i, v in enumerate(losses)]
    for epoch, m25, m50 in evals:
        lines.append({"step": (epoch + 1) * 2, "eval/epoch": epoch,
                      "eval/val_loss": 5.0, "eval/mAP@0.25": m25,
                      "eval/AR@0.25": 0.9, "eval/mAP@0.5": m50,
                      "eval/AR@0.5": 0.5})
    return lines


REF = _log([(9, 0.1, 0.05), (19, 0.3, 0.1), (29, 0.5, 0.2),
            (39, 0.6, 0.3)])
BANDS = (("mAP@0.25", 0.05), ("mAP@0.5", 0.05))
CASES = {
    # epochs >= 30 of 40: the last quarter is epoch 39 alone
    "pass": (_log([(9, 0.0, 0.0), (19, 0.1, 0.0), (29, 0.2, 0.1),
                   (39, 0.56, 0.26)]), "pass", []),
    "miss mAP@0.25": (_log([(9, 0.1, 0.1), (19, 0.3, 0.1), (29, 0.6, 0.3),
                            (39, 0.54, 0.3)]), "miss", ["mAP@0.25"]),
    "miss mAP@0.5": (_log([(9, 0.1, 0.1), (19, 0.3, 0.1), (29, 0.6, 0.3),
                           (39, 0.7, 0.2)]), "miss", ["mAP@0.5"]),
    "missing epoch": (_log([(9, 0.1, 0.1), (29, 0.6, 0.3),
                            (39, 0.7, 0.3)]), "incomplete", []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_curves_on_hand_made_logs(case):
    port, verdict, missed = CASES[case]
    got = cr.compare_curves(port, REF, BANDS)
    assert got["verdict"] == verdict
    assert got["last_quarter"] == [39]
    assert [m for m, b in got["bars"].items() if not b["pass"]] == missed
    assert got["missing"] == ([19] if verdict == "incomplete" else [])
    assert got["bars"]["mAP@0.25"]["bar"] == pytest.approx(0.55)
    assert got["bars"]["mAP@0.5"]["reference"] == pytest.approx(0.3)
    side = got["side_by_side"]
    assert side["best"]["reference"] == {"epoch": 39, "mAP@0.25": 0.6}
    assert side["train/loss last 10%"]["port"] == pytest.approx(8.0)
    assert side["val_loss"]["reference"] == pytest.approx(5.0)
    assert cr.comparison_text(case, got).startswith(f"{case}: {verdict}")


def test_compare_curves_bars_of_the_recipes():
    """The bars that compare_curves draws from the reference logs: the
    last-quarter means less the band (R1 epochs 349 and 399, R2 the same,
    R3 1599-1999)."""
    want = {"R1": {"mAP@0.25": 0.48345, "mAP@0.5": 0.2044},
            "R2": {"mAP@0.25": 0.6197, "mAP@0.5": 0.5606},
            "R3": {"mAP@0.25": 0.16322}}
    quarters = {"R1": [349, 399], "R2": [349, 399],
                "R3": [1599, 1699, 1799, 1899, 1999]}
    for key, recipe in cr.RECIPES.items():
        ref = cr.read_jsonl(cr.REFERENCE_DIR / recipe.reference)
        got = cr.compare_curves(ref, ref, recipe.bands)
        assert got["verdict"] == "pass" and got["last_quarter"] == \
            quarters[key]
        assert {m: b["bar"] for m, b in got["bars"].items()} == \
            pytest.approx(want[key])


def _committed():
    summary = cr.LOG_DIR / "summary.json"
    entries = json.loads(summary.read_text()) if summary.exists() else {}
    return sorted(entries.items())


def test_committed_logs_are_summarised():
    """Every committed log has its summary entry and the other way round;
    each of the three recipes has its log."""
    logs = sorted(p.stem for p in cr.LOG_DIR.glob("*.jsonl"))
    assert logs == [name for name, _ in _committed()]
    assert {cr.RECIPES[e["recipe"]].name for _, e in _committed()} == {
        r.name for r in cr.RECIPES.values()}


@pytest.mark.parametrize("name,entry", _committed(),
                         ids=[n for n, _ in _committed()])
def test_committed_log_gives_its_summary(name, entry):
    """The committed log covers every eval epoch of its reference, runs
    the recipe's full length, and compare_curves on it gives the verdict
    and numbers summary.json records."""
    recipe = cr.RECIPES[entry["recipe"]]
    log = cr.read_jsonl(cr.LOG_DIR / f"{name}.jsonl")
    ref = cr.read_jsonl(cr.REFERENCE_DIR / recipe.reference)
    assert set(cr.evals_by_epoch(ref)) <= set(cr.evals_by_epoch(log))
    assert max(r["step"] for r in log if "step" in r) == recipe.steps
    assert entry["steps"] == recipe.steps and entry["k"] == recipe.k
    got = cr.compare_curves(log, ref, recipe.bands)
    assert got == {k: entry[k] for k in got}
    assert "H100" in entry["card"]


def test_script_imports_no_jax_and_needs_the_card():
    """chip_recipes.py loads neither JAX nor the JAX package nor the
    tests, and refuses to train where torch.cuda finds no device."""
    code = (
        "import sys\n"
        "import chip_recipes\n"
        "bad = [m for m in sys.modules if m.split('.')[0]\n"
        "       in ('jax', 'flax', 'optax', 'tpu3dsad', 'tests')]\n"
        "assert not bad, bad\n"
    )
    root = Path(cr.__file__).parent
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr
    with pytest.raises(SystemExit, match="finds no device"):
        cr.main(["R1"])
