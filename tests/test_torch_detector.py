"""The whole-scene inference slice of the PyTorch port held against the JAX
package on the CPU, at a small config with the same (bridged) weights.

Integers must be equal: FPS picks and ball-query indices at every backbone
level, the proposal picks, and the served keep mask. Floats agree at rtol
1e-4, atol 1e-5 (fp32 matmuls summed in another order). The proposal FPS
runs on computed votes, so the stage is also checked on the JAX votes
themselves: a near-tie flip in the votes would show there as equal picks
on equal inputs, and here as the end-to-end test naming it.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu3dsad.ops as jops
import tpu3dsad_torch.config as tconfig
import tpu3dsad_torch.ops as tops
from tpu3dsad.config import Config, EvalConfig, ModelConfig
from tpu3dsad.data.synthetic import class_mean_sizes
from tpu3dsad.models.detector import SizeAdaptiveDetector as JDetector
from tpu3dsad.ops import boxes as jboxes
from tpu3dsad.ops.nms import nms_aabb as j_nms_aabb
from tpu3dsad.serving import build_inference_fn as j_build_inference_fn
from tpu3dsad_torch.eval.parse import parse_predictions
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.ops import boxes as tboxes
from tpu3dsad_torch.ops.nms import nms_aabb
from tpu3dsad_torch.serving import build_inference_fn
from tpu3dsad_torch.utils.bridge import load_flax_variables

from test_torch_nn import randomize

RTOL, ATOL = 1e-4, 1e-5
SMALL = ModelConfig(
    num_classes=4,
    sa_npoints=(64, 32, 16, 8),
    sa_nsamples=(16, 8, 8, 8),
    sa_channels=((16, 16), (16, 32), (16, 32), (16, 32)),
    fp_channels=((32, 32), (32, 32)),
    seed_feat_dim=32,
    num_proposals=16,
    cluster_nsample=8,
)


def to_port(ref):
    """The port's config dataclass holding the same values as the
    reference's `ref` (a Config or one of its sections)."""
    if isinstance(ref, Config):
        return tconfig.Config(model=to_port(ref.model),
                              data=to_port(ref.data),
                              train=to_port(ref.train),
                              eval=to_port(ref.eval))
    cls = getattr(tconfig, type(ref).__name__)
    return cls(**{f.name: getattr(ref, f.name)
                  for f in dataclasses.fields(cls)})


@pytest.fixture(scope="module")
def pair():
    """(jax model, flax variables, torch model, points, mask) on one scene
    batch with a padded tail in scene 1."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-0.5, 0.5, (2, 512, 3)).astype(np.float32)
    mask = np.ones((2, 512), bool)
    mask[1, 400:] = False
    pts[1, 400:] = 50.0
    jm = JDetector(SMALL)
    var = jax.jit(lambda k: jm.init(k, jnp.asarray(pts), mask=jnp.asarray(mask),
                                    train=False))(jax.random.key(0))
    var = randomize(var, seed=7)
    tm = SizeAdaptiveDetector(to_port(SMALL), device="cpu")
    load_flax_variables(tm, var)
    return jm, var, tm, pts, mask


def _record(monkeypatch, module, names, traced=False):
    """Wrap module.<name> so every call's index output is kept, in order
    (from inside a jit trace through an ordered callback if `traced`)."""
    seen = {n: [] for n in names}
    for n in names:
        fn = getattr(module, n)

        def wrapped(*a, _fn=fn, _n=n, **k):
            out = _fn(*a, **k)
            idx = out if _n == "furthest_point_sample" else out[1]
            keep = lambda v, _n=_n: seen[_n].append(np.asarray(v))  # noqa: E731
            if traced:
                jax.debug.callback(keep, idx, ordered=True)
            else:
                keep(idx)
            return out

        monkeypatch.setattr(module, n, wrapped)
    return seen


def test_backbone_fps_and_ball_query_indices_equal_at_every_level(pair):
    jm, var, tm, pts, mask = pair
    names = ("furthest_point_sample", "query_and_group")
    with pytest.MonkeyPatch.context() as mp:
        jseen = _record(mp, jops, names, traced=True)
        tseen = _record(mp, tops, names)
        jax.block_until_ready(jax.jit(
            lambda v, p, m: jm.apply(v, p, mask=m, train=False))(
                var, jnp.asarray(pts), jnp.asarray(mask)))
        jax.effects_barrier()
        with torch.no_grad():
            tm(torch.from_numpy(pts), mask=torch.from_numpy(mask))
    # 4 SA levels + the proposal FPS; 4 SA groupings + 3 bank radii
    assert [len(jseen[n]) for n in names] == [5, 7]
    assert [len(tseen[n]) for n in names] == [5, 7]
    for n in names:
        for level in range(4):
            np.testing.assert_array_equal(
                tseen[n][level], jseen[n][level], err_msg=f"{n} sa{level + 1}")


def test_proposal_stage_on_jax_votes(pair):
    jm, var, tm, pts, mask = pair
    ep = jax.jit(lambda v, p, m: jm.apply(v, p, mask=m, train=False))(
        var, jnp.asarray(pts), jnp.asarray(mask))
    with torch.no_grad():
        prop = tm.proposal(torch.tensor(np.asarray(ep["vote_xyz"])),
                           torch.tensor(np.asarray(ep["vote_features"])),
                           vote_mask=torch.tensor(np.asarray(ep["vote_mask"])))
    np.testing.assert_array_equal(prop["proposal_inds"].numpy(),
                                  np.asarray(ep["proposal_inds"]))
    np.testing.assert_array_equal(prop["proposal_mask"].numpy(),
                                  np.asarray(ep["proposal_mask"]))
    for key in ("proposal_xyz", "scale_logits", "raw_params"):
        np.testing.assert_allclose(prop[key].numpy(), np.asarray(ep[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


def test_end_points_key_by_key(pair):
    jm, var, tm, pts, mask = pair
    ep = jax.jit(lambda v, p, m: jm.apply(v, p, mask=m, train=False))(
        var, jnp.asarray(pts), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(pts), mask=torch.from_numpy(mask))
    assert set(got) == set(ep)
    for key, want in ep.items():
        want, have = np.asarray(want), got[key].numpy()
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(have, want, err_msg=key)
        else:
            np.testing.assert_allclose(have, want, rtol=RTOL, atol=ATOL,
                                       err_msg=key)


@pytest.mark.parametrize("eval_cfg", [
    EvalConfig(),  # the main path's defaults
    EvalConfig(nms_iou=0.02),  # suppresses harder
])
def test_served_keep_equals_jax(pair, eval_cfg):
    jm, var, tm, pts, mask = pair
    cfg = Config(model=SMALL, eval=eval_cfg)
    mean_sizes = tm.mean_sizes
    jout = j_build_inference_fn(cfg, var, mean_sizes)(jnp.asarray(pts),
                                                       jnp.asarray(mask))
    tout = build_inference_fn(to_port(cfg), tm, mean_sizes)(
        torch.from_numpy(pts), torch.from_numpy(mask))
    assert set(tout) == set(jout)
    keep = tout["keep"].numpy()
    np.testing.assert_array_equal(keep, np.asarray(jout["keep"]))
    assert 0 < keep.sum() < keep.size  # NMS suppressed some, kept some
    np.testing.assert_array_equal(tout["sem_cls"].numpy(),
                                  np.asarray(jout["sem_cls"]))
    for key in ("center", "size", "heading", "obj_prob"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("cls_nms", [False, True])
def test_nms_aabb_equals_jax(cls_nms):
    rng = np.random.default_rng(8)
    B, K = 3, 40
    center = rng.uniform(-1, 1, (B, K, 3)).astype(np.float32)
    size = rng.uniform(0.3, 1.2, (B, K, 3)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, (B, K)).astype(np.float32)
    scores = rng.choice([0.2, 0.5, 0.9], (B, K)).astype(np.float32)  # ties
    valid = rng.random((B, K)) < 0.8
    sem = rng.integers(0, 3, (B, K))
    corners = tboxes.box_corners(*map(torch.from_numpy, (center, size, heading)))
    jcorners = jboxes.box_corners(*map(jnp.asarray, (center, size, heading)))
    np.testing.assert_allclose(corners.numpy(), np.asarray(jcorners),
                               rtol=RTOL, atol=ATOL)
    bmin, bmax = tboxes.corners_to_aabb(corners)
    keep = nms_aabb(bmin, bmax, torch.from_numpy(scores),
                    torch.from_numpy(valid), 0.25,
                    sem_cls=torch.from_numpy(sem) if cls_nms else None)
    jkeep = j_nms_aabb(jnp.asarray(bmin.numpy()), jnp.asarray(bmax.numpy()),
                       jnp.asarray(scores), jnp.asarray(valid), 0.25,
                       sem_cls=jnp.asarray(sem) if cls_nms else None)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert 0 < keep.sum() < valid.sum()  # some boxes suppressed


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="A5b"):
        SizeAdaptiveDetector(ModelConfig(proposal_sampling="density"),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="A5b"):
        SizeAdaptiveDetector(ModelConfig(proposal_mode="lineage"),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="A5b"):
        parse_predictions({}, np.ones((4, 3), np.float32), 12,
                          EvalConfig(use_oriented_nms=True))


@pytest.mark.parametrize("name", ["ModelConfig", "EvalConfig"])
def test_port_config_defaults_equal_reference(name):
    """Every field of the port's config exists in the reference's, with
    the same default."""
    port = getattr(tconfig, name)()
    ref = {"ModelConfig": ModelConfig, "EvalConfig": EvalConfig}[name]()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert to_port(Config()) == tconfig.Config()


@pytest.mark.parametrize("num_classes", [1, 4, 10, 18])
def test_class_mean_sizes_equal_reference(num_classes):
    np.testing.assert_array_equal(tconfig.class_mean_sizes(num_classes),
                                  class_mean_sizes(num_classes))


def test_port_imports_without_jax():
    """Neither JAX nor any module of the JAX package is loaded."""
    code = (
        "import sys\n"
        "import tpu3dsad_torch, tpu3dsad_torch.serving, tpu3dsad_torch.ops\n"
        "import tpu3dsad_torch.models.detector, tpu3dsad_torch.utils.bridge\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'tpu3dsad')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
