"""The port's lineage VoteNet importer (tpu3dsad_torch/utils/import_torch)
held against the JAX package's (tpu3dsad/utils/import_torch.py) and the
torch lineage reference (tests/modules/torch_votenet_ref.py), on the CPU.

Tolerances, with their reasons:

  * the imported state_dict: bitwise the reference's import carried into
    the port's names by utils/bridge.py (both copy the same float32
    values; only the reference's transpose and the bridge's transpose
    back stand between them), with the same copied and skipped key
    lists in the same order;
  * the imported detector's forward against TorchVoteNetRef: the
    reference's own bars for its import (tests/modules/
    test_detector_torch_parity.py): seed_xyz atol 1e-6 (the same FPS
    picks of the same points), seed / vote / proposal features and
    centers atol 5e-4, raw_params atol 2e-3 rtol 1e-4 (fp32 1x1
    convolutions against nn.Linear, summed in other orders through five
    layers of MLPs).
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from tests.modules.test_detector_torch_parity import (
    FP_CH, NC, NH, OUT_CH, P, SA_CH, SA_K, SA_NP, SA_R,
)
from tests.modules.test_import_cli import _OVERRIDES, N_PTS
from tests.modules.torch_votenet_ref import TorchVoteNetRef
from tpu3dsad.config import ModelConfig
from tpu3dsad.models.detector import SizeAdaptiveDetector as JDetector
from tpu3dsad.utils import import_torch as j_import
from tpu3dsad_torch import train_lib
from tpu3dsad_torch.config import parse_cli
from tpu3dsad_torch.train_detector import build_detector
from tpu3dsad_torch.utils import import_torch as t_import
from tpu3dsad_torch.utils.bridge import state_dict_from_flax


def lineage_ref(seed=3):
    ref = TorchVoteNetRef(
        3, SA_NP, SA_R, SA_K, SA_CH, FP_CH, num_proposals=P,
        proposal_radius=0.3, proposal_nsample=8, out_ch=OUT_CH).eval()
    ref.randomize_bn(torch.Generator().manual_seed(seed))
    return ref


def seeded_state_dict(bn_prefix="bn") -> dict:
    """Lineage names and shapes of TorchVoteNetRef, values drawn from a
    seed (running variances positive); bn_prefix='bn.bn' names the shared
    MLPs' BatchNorms as the lineage's BNMomentum wrapper does."""
    rng = np.random.default_rng(21)
    out = {}
    for k, v in lineage_ref().state_dict().items():
        if "num_batches_tracked" in k:
            continue
        if k.endswith("running_var"):
            value = rng.uniform(0.5, 1.5, v.shape)
        else:
            value = rng.standard_normal(v.shape)
        k = k.replace(".bn.", f".{bn_prefix}.") if ".conv" not in k else k
        out[k] = value.astype(np.float32)
    return out


def port_model(mode: str):
    cfg = parse_cli([*_OVERRIDES, f"model.proposal_mode={mode}"])
    return build_detector(cfg, device="cpu")


def reference_variables(mode: str) -> dict:
    cfg = ModelConfig(
        num_classes=NC, num_heading_bins=NH, num_proposals=P,
        sa_npoints=SA_NP, sa_radii=SA_R, sa_nsamples=SA_K, sa_channels=SA_CH,
        fp_channels=FP_CH, seed_feat_dim=FP_CH[1][-1], proposal_mode=mode,
        proposal_radius=0.3, cluster_nsample=8, append_height=False)
    pts = jnp.zeros((1, N_PTS, 3), jnp.float32)
    model = JDetector(cfg)
    v = jax.jit(lambda key: model.init(key, pts, pts, train=False))(
        jax.random.key(0))
    return {c: jax.tree.map(np.asarray, v[c])
            for c in ("params", "batch_stats")}


@pytest.mark.parametrize("mode,bn_prefix,drop",
                         [("lineage", "bn", ""), ("lineage", "bn.bn", ""),
                          ("lineage", "bn", "pnet."),
                          ("adaptive", "bn", "")])
def test_import_equals_reference_bridged(mode, bn_prefix, drop):
    """lineage: every tensor placed, all of the port's state_dict filled;
    without pnet.* the head keeps its weights; adaptive: the pnet.*
    tensors are skipped, in the reference's order."""
    sd = {k: v for k, v in seeded_state_dict(bn_prefix).items()
          if not (drop and k.startswith(drop))}
    want_vars, want_copied, want_skipped = j_import.import_lineage_weights(
        sd, reference_variables(mode))
    model = port_model(mode)
    target = model.state_dict()
    got, copied, skipped = t_import.import_lineage_weights(sd, target)
    assert copied == want_copied and skipped == want_skipped
    placed = [k for k in got if got[k] is not target[k]]
    assert len(placed) == len(copied)
    want = state_dict_from_flax(want_vars, target)
    for key in placed:
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], want[key]), key
    if mode == "lineage" and not drop:
        assert skipped == [] and sorted(placed) == sorted(target)
    if mode == "adaptive":
        assert skipped and all(k.startswith("pnet.") for k in skipped)
    model.load_state_dict(got)  # complete and of the right shapes


def test_import_refuses_a_shape_mismatch():
    sd = seeded_state_dict()
    sd["vgen.conv3.weight"] = sd["vgen.conv3.weight"][:-1]
    with pytest.raises(ValueError, match="voting.out.weight"):
        t_import.import_lineage_weights(sd, port_model("lineage").state_dict())
    sd = seeded_state_dict()
    sd["vgen.conv1.weight"] = np.repeat(sd["vgen.conv1.weight"], 3, -1)
    with pytest.raises(ValueError, match="not a 1x1 conv"):
        t_import.import_lineage_weights(sd, port_model("lineage").state_dict())


def test_import_cli_round_trip_meets_the_lineage_reference(tmp_path,
                                                           capsys):
    """checkpoint.tar -> the CLI -> ckpt_1.pt, restored as evaluation
    restores it: the lineage-mode forward meets TorchVoteNetRef's."""
    ref = lineage_ref()
    tar = tmp_path / "checkpoint.tar"
    torch.save({"epoch": 7, "model_state_dict": ref.state_dict()}, tar)
    out = tmp_path / "ckpt"
    report = t_import.main([f"ckpt={tar}", f"out={out}", "device=cpu",
                            *_OVERRIDES])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == report
    assert report["skipped"] == []
    assert report["copied"] == report["total_source_tensors"] == len(
        [k for k in ref.state_dict() if "num_batches_tracked" not in k])
    assert sorted(p.name for p in out.iterdir()) == ["ckpt_1.pt"]

    model = port_model("lineage")
    assert train_lib.restore_checkpoint(str(out), model, None,
                                        for_eval=True) == 1
    # the step-1 checkpoint resumes training: its optimizer state loads
    optimizer = train_lib.make_optimizer(
        parse_cli(_OVERRIDES).train, 10, model.parameters())
    assert train_lib.restore_checkpoint(str(out), model, optimizer) == 1

    rng = np.random.default_rng(0)
    points = rng.uniform(-1.5, 1.5, (2, N_PTS, 3)).astype(np.float32)
    feats = rng.standard_normal((2, N_PTS, 3)).astype(np.float32)
    with torch.no_grad():
        want = ref(points, feats)
        got = model.eval()(torch.from_numpy(points), torch.from_numpy(feats))
    got = {k: v.numpy() for k, v in got.items()
           if isinstance(v, torch.Tensor)}
    np.testing.assert_allclose(got["seed_xyz"], want["seed_xyz"], atol=1e-6)
    for key in ("seed_features", "vote_xyz", "proposal_xyz"):
        np.testing.assert_allclose(got[key], want[key], atol=5e-4,
                                   err_msg=key)
    np.testing.assert_allclose(got["raw_params"], want["raw_params"],
                               atol=2e-3, rtol=1e-4)


def test_import_cli_exits_1_on_an_extra_tensor(tmp_path):
    """A tensor the model has no place for: the checkpoint is written, the
    report names the tensor, and the process exits 1 (python -m)."""
    sd = {k: torch.from_numpy(v) for k, v in seeded_state_dict().items()}
    sd["pnet.extra_head.weight"] = torch.zeros(4, 4)
    tar = tmp_path / "checkpoint.tar"
    torch.save(sd, tar)  # a bare state_dict
    proc = subprocess.run(
        [sys.executable, "-m", "tpu3dsad_torch.utils.import_torch",
         f"ckpt={tar}", f"out={tmp_path / 'ckpt'}", "device=cpu",
         *_OVERRIDES],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["skipped"] == ["pnet.extra_head.weight"]
    assert "unported lineage tensors" in proc.stderr
    assert (tmp_path / "ckpt" / "ckpt_1.pt").exists()
