"""The port's train entry (tpu3dsad_torch/train.py, the reference's root
train.py) with the config fields the reference's command lines pass:
train.profile_dir, train.tb_dir and ops_impl, on the CPU.

What is compared, and how: the entry trains each model as its runner
does; ops_impl=xla and ops_impl=pallas give every step's loss bitwise
equal to the default's (the field selects nothing in the port); the
profiler leaves a Chrome trace of the first epoch run, and closes on a
resumed run with no epoch left (the reference's regression,
tests/e2e/test_run_detector.py::test_profile_dir_writes_trace); tb_dir
leaves a TensorBoard event file whose scalars are the JSON lines'.
"""

import dataclasses
import glob
import inspect
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from tpu3dsad import config as jconfig
from tpu3dsad_torch import train as entry
from tpu3dsad_torch import train_classifier, train_lib
from tpu3dsad_torch.config import Config, parse_cli
from tpu3dsad_torch.utils.metrics import MetricsLogger

# a narrow detector on the card's synthetic feed: 64 // 8 = 8 steps an
# epoch at 512 points
DETECTOR = [
    "model.name=detector", "data.name=synthetic", "data.device_synth=true",
    "data.num_points=512", "data.max_boxes=8", "model.num_classes=4",
    "model.sa_npoints=(64,32,16,8)", "model.sa_nsamples=(16,8,8,8)",
    "model.sa_channels=((16,16),(16,32),(16,32),(16,32))",
    "model.fp_channels=((32,32),(32,32))", "model.seed_feat_dim=32",
    "model.num_proposals=16", "model.cluster_nsample=8",
    "train.batch_size=8", "train.num_epochs=1", "train.eval_every=5",
    "train.log_every=4",
]


def test_new_config_fields_have_the_reference_defaults():
    port, ref = Config(), jconfig.Config()
    assert port.ops_impl == ref.ops_impl == "xla"
    for name in ("profile_dir", "tb_dir"):
        assert getattr(port.train, name) == getattr(ref.train, name) == ""
    cfg = parse_cli(["train.profile_dir=/p", "train.tb_dir=/t",
                     "ops_impl=pallas"])
    assert (cfg.train.profile_dir, cfg.train.tb_dir, cfg.ops_impl) == (
        "/p", "/t", "pallas")


def test_entry_trains_the_detector(tmp_path, capsys):
    result = entry.main([*DETECTOR, f"train.ckpt_dir={tmp_path}"],
                        device="cpu")
    assert (result.start_step, result.step) == (0, 8)
    assert np.isfinite([h["loss"] for h in result.history]).all()
    captured = capsys.readouterr()
    assert "model: ModelConfig(name='detector'" in captured.err
    rows = [json.loads(line) for line in captured.out.splitlines()]
    assert [r["step"] for r in rows if "train/loss" in r] == [4, 8]
    assert (tmp_path / "ckpt_8.pt").exists()


def test_entry_trains_the_classifier(tmp_path, monkeypatch):
    monkeypatch.setattr(train_classifier, "SYNTHETIC_STEPS_PER_EPOCH", 2)
    monkeypatch.setattr(train_classifier, "SYNTHETIC_VAL_BATCHES", 2)
    result = entry.main(["preset=classifier", "data.num_points=64",
                         "train.batch_size=2", "model.num_classes=4",
                         "train.num_epochs=1", "train.eval_every=1",
                         f"train.ckpt_dir={tmp_path}"], device="cpu")
    assert isinstance(result, train_classifier.ClassifierResult)
    assert (result.start_step, result.step) == (0, 2)
    assert np.isfinite([h["loss"] for h in result.history]).all()
    (ev,) = result.evals
    assert 0.0 <= ev["val_acc"] <= 1.0
    assert (tmp_path / "ckpt_2.pt").exists()


def test_entry_refuses_an_unknown_model(tmp_path):
    with pytest.raises(SystemExit, match="unknown model.name=segmenter"):
        entry.main(["model.name=segmenter", f"train.ckpt_dir={tmp_path}"],
                   device="cpu")
    assert not tmp_path.joinpath("ckpt_1.pt").exists()


def test_entry_defaults_to_the_card():
    assert inspect.signature(entry.main).parameters["device"].default == (
        "cuda")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ops_impl_changes_nothing(tmp_path, impl):
    """Every step's loss bitwise the default command line's."""
    args = [*DETECTOR, "train.num_epochs=1"]
    base = entry.main([*args, f"train.ckpt_dir={tmp_path / 'a'}"],
                      device="cpu")
    other = entry.main([*args, f"train.ckpt_dir={tmp_path / 'b'}",
                        f"ops_impl={impl}"], device="cpu")
    assert [h["loss"] for h in other.history] == [
        h["loss"] for h in base.history]


def test_ops_impl_unknown_value_raises(tmp_path):
    with pytest.raises(ValueError, match="ops_impl must be one of"):
        entry.main([*DETECTOR, "ops_impl=tpu",
                    f"train.ckpt_dir={tmp_path}"], device="cpu")
    with pytest.raises(ValueError, match="ops_impl"):
        train_lib.apply_runtime_config(
            dataclasses.replace(Config(), ops_impl="cuda"))


def test_profile_dir_traces_the_first_epoch_and_closes_on_resume(tmp_path):
    """Two epochs: the trace covers the first one's steps. A resumed run
    with no epoch left still stops the profiler and writes its trace."""
    profile = tmp_path / "profile"
    args = [*DETECTOR, "train.num_epochs=2", f"train.ckpt_dir={tmp_path}",
            f"train.profile_dir={profile}"]
    entry.main(args, device="cpu")
    trace = profile / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(str(e.get("name")).startswith("aten::") for e in events)
    assert not torch.autograd._profiler_enabled()
    trace.unlink()
    again = entry.main(args, device="cpu")
    assert (again.start_step, again.step) == (16, 16)
    assert trace.exists()
    assert not torch.autograd._profiler_enabled()


def test_tb_dir_writes_scalars_beside_the_json_lines(tmp_path, capsys):
    pytest.importorskip("torch.utils.tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    tb = tmp_path / "tb"
    entry.main([*DETECTOR, f"train.ckpt_dir={tmp_path / 'c'}",
                f"train.tb_dir={tb}"], device="cpu")
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if "train/loss" in line]
    (event_file,) = glob.glob(str(tb / "events.out.tfevents.*"))
    acc = EventAccumulator(event_file)
    acc.Reload()
    scalars = acc.Scalars("train/loss")
    assert [s.step for s in scalars] == [r["step"] for r in rows] == [4, 8]
    np.testing.assert_allclose([s.value for s in scalars],
                               [r["train/loss"] for r in rows], rtol=1e-6)


def test_metrics_logger_without_tensorboard_notes_once(tmp_path, capsys,
                                                       monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = MetricsLogger(str(tmp_path / "tb"))
    logger.log(3, {"loss": 0.5, "name": "x"}, prefix="train/")
    logger.flush()
    captured = capsys.readouterr()
    assert captured.err.count("tensorboard unavailable") == 1
    assert json.loads(captured.out) == {"step": 3, "train/loss": 0.5}
    assert not (tmp_path / "tb").exists()


def test_entry_runs_as_a_module(tmp_path):
    """python -m tpu3dsad_torch.train: the config on stderr, and an unknown
    model.name ends the process naming it."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpu3dsad_torch.train", "model.name=nope",
         f"train.ckpt_dir={tmp_path}"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    assert "unknown model.name=nope" in proc.stderr
    assert "train: TrainConfig(" in proc.stderr
