"""Evaluation (config #4's inference path) of the PyTorch port held against
the JAX package on the CPU: the AP calculator and the host parsing on the
same inputs, the whole val sweep from bridged weights, and the
eval_detector entry point restoring a port checkpoint.

Tolerances, with their reasons:

  * AP, IoU, host parsing on the same numpy inputs: exactly equal (the
    same numpy code);
  * the val sweep: keep and the per-scene detection lists (class, order)
    equal; scores within rtol 1e-5 and corners within rtol 1e-4, atol 1e-4
    (fp32 matmuls summed in another order, as tests/test_torch_detector.py
    allows for the forward); mAP, AR and per-class AP within 1e-6 (a
    different value would mean a different match); val_loss within 1e-4
    of the reference's after both round it to 4 places.

Both sides group exactly (the reference with ops_fast_grouping=False) and
emit every kept proposal (eval.objectness_thresh=0, eval.conf_thresh=0).
"""

import dataclasses
import importlib
import inspect
import json
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

import tpu3dsad.ops as jops
from tpu3dsad import config as jconfig
from tpu3dsad import train_lib as jtrain
from tpu3dsad.data import kitti as jkitti
from tpu3dsad.data.synthetic_outdoor import write_dataset
from tpu3dsad.eval import ap as jap
from tpu3dsad.eval import parse as jparse
from tpu3dsad.train_detector import build_detector as j_build_detector
from tpu3dsad_torch import eval_detector, train_lib
from tpu3dsad_torch import train_detector as tdet
from tpu3dsad_torch.config import parse_cli
from tpu3dsad_torch.data import get_dataset
from tpu3dsad_torch.data import kitti as tkitti
from tpu3dsad_torch.eval import ap as tap
from tpu3dsad_torch.eval import parse as tparse
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.utils.bridge import load_flax_variables

from test_torch_detector import to_port
from test_torch_nn import randomize

jdet = importlib.import_module("tpu3dsad.train_detector")


def _boxes(rng, n):
    center = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    size = rng.uniform(0.5, 3.0, (n, 3)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    return center, size, heading


def _scenes(seed=40, scenes=4, classes=3):
    """Ground truth and detections (noisy copies of the truth plus random
    boxes, with tied scores) per scene, as (class, corners[, score])."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(scenes):
        c, s, h = _boxes(rng, 6)
        cls = rng.integers(0, classes, 6)
        gt_corners = jparse._box_corners_np(c, s, h)
        gts.append([(int(k), g) for k, g in zip(cls, gt_corners)])
        noisy = jparse._box_corners_np(
            c + rng.normal(0, 0.3, c.shape).astype(np.float32),
            s * rng.uniform(0.8, 1.2, s.shape).astype(np.float32),
            h + rng.normal(0, 0.3, h.shape).astype(np.float32))
        rc, rs, rh = _boxes(rng, 5)
        extra = jparse._box_corners_np(rc, rs, rh)
        scores = rng.choice([0.2, 0.5, 0.7, 0.9], 11)
        kinds = np.concatenate([cls, rng.integers(0, classes, 5)])
        preds.append([(int(k), b, float(sc)) for k, b, sc in
                      zip(kinds, np.concatenate([noisy, extra]), scores)])
    return preds, gts


@pytest.mark.parametrize("thresh", [0.25, 0.5])
def test_ap_calculator_equals_reference(thresh):
    preds, gts = _scenes()
    names = ("car", "pedestrian", "cyclist")
    got = tap.APCalculator(thresh, names)
    want = jap.APCalculator(thresh, names)
    for calc in (got, want):
        calc.step(preds[:2], gts[:2])
        calc.step(preds[2:], gts[2:])
    g, w = got.compute_metrics(), want.compute_metrics()
    assert g == w
    assert 0 < g["mAP"] < 1  # some matches, some misses


def test_iou_and_voc_ap_equal_reference():
    rng = np.random.default_rng(41)
    a = jparse._box_corners_np(*_boxes(rng, 30))
    b = jparse._box_corners_np(*_boxes(rng, 30))
    b[:10] = a[:10] + rng.normal(0, 0.2, (10, 1, 3)).astype(np.float32)
    ious = [tap.box3d_iou_oriented(x, y) for x, y in zip(a, b)]
    assert ious == [jap.box3d_iou_oriented(x, y) for x, y in zip(a, b)]
    assert max(ious) > 0.3 and min(ious) == 0.0
    rec = np.sort(rng.random(20))
    prec = rng.random(20)
    for use_07 in (False, True):
        assert tap.voc_ap(rec, prec, use_07) == jap.voc_ap(rec, prec, use_07)


@pytest.mark.parametrize("per_class", [True, False])
def test_host_parsing_equals_reference(per_class):
    rng = np.random.default_rng(42)
    B, P, C = 3, 20, 3
    parsed = {
        "keep": rng.random((B, P)) < 0.6,
        "corners": rng.normal(size=(B, P, 8, 3)).astype(np.float32),
        "obj_prob": rng.choice([0.01, 0.05, 0.3, 0.8], (B, P)).astype(
            np.float32),
        "sem_prob": rng.dirichlet(np.ones(C + 1), (B, P)).astype(np.float32),
        "sem_cls": rng.integers(0, C, (B, P)),
    }
    ev = jconfig.EvalConfig(per_class_proposal=per_class)
    got = tparse.predictions_to_lists(parsed, to_port(ev), C)
    want = jparse.predictions_to_lists(parsed, ev, C)
    assert [len(s) for s in got] == [len(s) for s in want]
    assert sum(len(s) for s in got) > 0
    for gs, ws in zip(got, want):
        for (gc, gb, gsc), (wc, wb, wsc) in zip(gs, ws):
            assert (gc, gsc) == (wc, wsc)
            np.testing.assert_array_equal(gb, wb)
    c, s, h = _boxes(rng, B * 5)
    batch = {"gt_centers": c.reshape(B, 5, 3), "gt_sizes": s.reshape(B, 5, 3),
             "gt_headings": h.reshape(B, 5),
             "gt_classes": rng.integers(0, C, (B, 5)).astype(np.int32),
             "gt_mask": rng.random((B, 5)) < 0.7}
    got, want = tparse.parse_groundtruths(batch), jparse.parse_groundtruths(
        batch)
    assert [[k for k, _ in sc] for sc in got] == [[k for k, _ in sc]
                                                  for sc in want]
    for gs, ws in zip(got, want):
        for (_, gb), (_, wb) in zip(gs, ws):
            np.testing.assert_array_equal(gb, wb)


# ---------------------------------------------------------- the val sweep

TINY = [
    "preset=outdoor", "data.num_points=256", "data.augment=false",
    "model.sa_npoints=(64,32,16,8)", "model.sa_nsamples=(8,8,4,4)",
    "model.sa_channels=((16,16),(16,32),(16,32),(16,32))",
    "model.fp_channels=((32,32),(32,32))", "model.seed_feat_dim=32",
    "model.num_proposals=16", "model.cluster_nsample=4",
    "train.batch_size=2", "eval.objectness_thresh=0", "eval.conf_thresh=0",
    "ops_fast_grouping=false",
]
# random weights place no box on a ground-truth box; at an IoU threshold
# of 0 the highest-scored detection of a class in a scene takes that
# scene's first ground truth of the class, so AP and AR follow the score
# order the two sides must share
SWEEP = TINY + ["eval.ap_iou_threshs=(0.0,0.25)"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """3 val scenes (two batches of 2, the second padded) and 1 train scene
    of 40000 points, written once; each user copies the directory."""
    root = tmp_path_factory.mktemp("outdoor") / "scenes"
    write_dataset(str(root), scenes=1, val_scenes=3, num_points=40000,
                  seed=7)
    return root


def _copy(scenes, dst):
    shutil.copytree(scenes, dst)
    return str(dst)


def _recorder(monkeypatch, module):
    """Keep every predictions_to_lists output of `module`'s evaluate."""
    seen = []
    fn = module.predictions_to_lists

    def wrapped(*a, **k):
        out = fn(*a, **k)
        seen.append(out)
        return out

    monkeypatch.setattr(module, "predictions_to_lists", wrapped)
    return seen


def test_evaluate_equals_reference(scenes, tmp_path, monkeypatch):
    ref = jconfig.parse_cli(SWEEP + [f"data.root={_copy(scenes, tmp_path / 'j')}"])
    jops.set_fast_grouping(False)  # exact, as the port groups
    jds = jkitti.KittiDetectionDataset(ref)
    jm = j_build_detector(ref, jds.mean_sizes)
    first = next(jds.val_batches(np.random.default_rng(0), 2))
    var = jax.jit(lambda k: jm.init(
        k, jnp.asarray(first["points"]), mask=jnp.asarray(first["point_mask"]),
        train=False))(jax.random.key(0))
    var = randomize(var, seed=11)
    state = jtrain.TrainState.create(
        apply_fn=jm.apply, params=var["params"],
        batch_stats=var["batch_stats"],
        tx=jtrain.make_optimizer(ref.train, 10))
    _, j_eval_step = jtrain.make_detector_steps(jm, ref)
    j_keep, t_keep = [], []
    j_parse_fn = jax.jit(lambda ep: jparse.parse_predictions(
        ep, jm._mean_sizes(), ref.model.num_heading_bins, ref.eval))

    def j_parse(ep):
        out = j_parse_fn(ep)
        j_keep.append(np.asarray(out["keep"]))
        return out

    j_lists = _recorder(monkeypatch, jdet)
    want = jdet.evaluate(ref, jm, state, jds, j_eval_step, j_parse)

    cfg = dataclasses.replace(to_port(ref), data=dataclasses.replace(
        to_port(ref).data, root=_copy(scenes, tmp_path / "t")))
    tds = get_dataset(cfg, device="cpu")
    model = SizeAdaptiveDetector(cfg.model, tds.mean_sizes, device="cpu")
    load_flax_variables(model, var)
    step = train_lib.make_detector_eval_step(model, cfg)

    def t_parse(ep):
        out = tparse.parse_predictions(ep, model.mean_sizes,
                                       cfg.model.num_heading_bins, cfg.eval)
        t_keep.append(out["keep"].numpy())
        return out

    t_lists = _recorder(monkeypatch, tdet)
    got = tdet.evaluate(cfg, model, tds, step, t_parse)

    assert len(t_keep) == len(j_keep) == 2
    for g, w in zip(t_keep, j_keep):
        np.testing.assert_array_equal(g, w)
    assert 0 < sum(k.sum() for k in t_keep)
    for gb, wb in zip(t_lists, j_lists):
        assert [len(s) for s in gb] == [len(s) for s in wb]
        for gs, ws in zip(gb, wb):
            assert [d[0] for d in gs] == [d[0] for d in ws]
            np.testing.assert_allclose([d[2] for d in gs],
                                       [d[2] for d in ws], rtol=1e-5)
            for (_, gc, _), (_, wc, _) in zip(gs, ws):
                np.testing.assert_allclose(gc, wc, rtol=1e-4, atol=1e-4)
    assert set(got) == set(want)
    assert want["mAP@0.0"] > 0
    assert abs(got["val_loss"] - want["val_loss"]) <= 1e-4
    for key, value in want.items():
        if isinstance(value, dict):
            assert set(got[key]) == set(value)
            for name, ap in value.items():
                assert abs(got[key][name] - ap) <= 1e-6, (key, name)
        elif key != "val_loss":
            assert abs(got[key] - value) <= 1e-6, key


def test_run_eval_restores_a_port_checkpoint(scenes, tmp_path, capsys):
    cfg = parse_cli(TINY + [f"data.root={_copy(scenes, tmp_path / 'd')}",
                            f"train.ckpt_dir={tmp_path / 'ckpt'}"])
    empty = eval_detector.run_eval(cfg, device="cpu")
    assert empty["ckpt_step"] == 0
    assert "no checkpoint found" in capsys.readouterr().err

    model = tdet.build_detector(cfg, tkitti.KITTI_MEAN_SIZES, device="cpu")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.add_(0.1 * torch.randn(t.shape, generator=gen)).abs_()
    optim = train_lib.make_optimizer(cfg.train, 1, model.parameters())
    train_lib.save_checkpoint(cfg.train.ckpt_dir, model, optim, 7)
    out = eval_detector.run_eval(cfg, device="cpu")
    assert out["ckpt_step"] == 7
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(printed) == out
    direct = tdet.evaluate(
        cfg, model, get_dataset(cfg, device="cpu"),
        train_lib.make_detector_eval_step(model, cfg),
        lambda ep: tparse.parse_predictions(
            ep, model.mean_sizes, cfg.model.num_heading_bins, cfg.eval))
    assert {"ckpt_step": 7, **direct} == out
    assert out["val_loss"] != empty["val_loss"]  # the saved weights ran


def test_unported_eval_options_raise(scenes, tmp_path, capsys):
    """eval.use_best, once refused (ROADMAP A7.6), now evaluates the
    best-mAP snapshot under <ckpt_dir>/best and not the newest checkpoint;
    with no snapshot there are no weights to restore, as in the reference
    (tests/e2e/test_best_checkpoint.py)."""
    cfg = parse_cli(TINY + [f"data.root={_copy(scenes, tmp_path / 'd')}",
                            "eval.use_best=true",
                            f"train.ckpt_dir={tmp_path / 'ckpt'}"])
    ckpt = cfg.train.ckpt_dir
    model = tdet.build_detector(cfg, tkitti.KITTI_MEAN_SIZES, device="cpu")
    optim = train_lib.make_optimizer(cfg.train, 1, model.parameters())
    train_lib.save_checkpoint(ckpt, model, optim, 7)
    assert eval_detector.run_eval(cfg, device="cpu")["ckpt_step"] == 0
    assert "no checkpoint found" in capsys.readouterr().err
    assert train_lib.save_best_checkpoint(ckpt, model, optim, 5, 0.25)
    train_lib.save_checkpoint(ckpt, model, optim, 9)
    assert eval_detector.run_eval(cfg, device="cpu")["ckpt_step"] == 5
    fresh = tdet.build_detector(cfg, device="cpu")
    assert train_lib.restore_checkpoint(ckpt, fresh, None, for_eval=True,
                                        use_best=True) == 5
    assert train_lib.restore_checkpoint(ckpt, fresh, None,
                                        for_eval=True) == 9


def test_eval_entry_point_parses_the_command_line_and_defaults_to_the_card(
        monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(eval_detector, "run_eval",
                        lambda cfg: seen.append(cfg) or {})
    eval_detector.main(["preset=outdoor", "data.root=/scenes",
                        "data.device_preproc=true", "train.ckpt_dir=/ckpt"])
    (cfg,) = seen
    assert (cfg.data.name, cfg.data.root, cfg.data.device_preproc,
            cfg.data.num_points, cfg.train.ckpt_dir) == (
                "kitti", "/scenes", True, 16384, "/ckpt")
    assert capsys.readouterr().err.startswith("model: ")
    monkeypatch.undo()
    for fn in (eval_detector.run_eval, tkitti.device_fps, get_dataset,
               tkitti.KittiDetectionDataset.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_outdoor_and_eval_modules_import_without_jax():
    code = (
        "import sys\n"
        "import tpu3dsad_torch.eval_detector, tpu3dsad_torch.presets\n"
        "import tpu3dsad_torch.eval.ap, tpu3dsad_torch.eval.parse\n"
        "import tpu3dsad_torch.data.kitti, tpu3dsad_torch.data.host\n"
        "import tpu3dsad_torch.data.pipeline\n"
        "import tpu3dsad_torch.data.synthetic_outdoor\n"
        "import tpu3dsad_torch.ops.sorted, tpu3dsad_torch.ops.cuda.fps\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'tpu3dsad')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
