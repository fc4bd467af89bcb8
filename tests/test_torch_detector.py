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

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

import tpu3dsad.ops as jops
import tpu3dsad_torch.config as tconfig
import tpu3dsad_torch.ops as tops
from tpu3dsad.config import Config, EvalConfig, ModelConfig
from tpu3dsad.data.synthetic import class_mean_sizes
from tpu3dsad.models.detector import SizeAdaptiveDetector as JDetector
from tpu3dsad.ops import boxes as jboxes
from tpu3dsad.ops.nms import _greedy_suppress as j_greedy_suppress
from tpu3dsad.ops.nms import nms_aabb as j_nms_aabb
from tpu3dsad.serving import build_inference_fn as j_build_inference_fn
from tpu3dsad_torch.eval.parse import parse_predictions
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.ops import boxes as tboxes
from tpu3dsad_torch.ops.nms import nms_aabb
from tpu3dsad_torch.serving import build_inference_fn
from tpu3dsad_torch.utils.bridge import load_flax_variables

from test_torch_nms_kernel import CASES as NMS_CASES
from test_torch_nms_kernel import case_id as nms_case_id
from test_torch_nms_kernel import make_case as make_nms_case
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
                  for f in dataclasses.fields(cls)
                  if f.name not in PORT_ONLY})


# the port's own fields (3DSSD's, model.name='ssd3d', and Group-Free 3D's,
# model.name='groupfree3d'), which the reference has not: they keep the
# port's defaults
PORT_ONLY = frozenset(f.name for f in dataclasses.fields(tconfig.ModelConfig)
                      if f.name.startswith(("ssd3d_", "groupfree_")))


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


@pytest.mark.parametrize("thresh", [0.02, 0.25, 0.99])
@pytest.mark.parametrize("cls_nms", [False, True])
def test_walk_op_on_cpu_is_the_plain_loop_and_jax(cls_nms, thresh):
    """The custom op tpu3dsad_torch::greedy_suppress on CPU tensors runs
    the plain loop (no kernel launch) and keeps what the JAX package's
    nms_aabb keeps, on the class-shifted IoU that nms_aabb builds."""
    from tpu3dsad_torch.ops import library
    from tpu3dsad_torch.ops.cuda import nms as cuda_nms

    rng = np.random.default_rng(9)
    B, K = 3, 40
    center = rng.uniform(-1, 1, (B, K, 3)).astype(np.float32)
    size = rng.uniform(0.3, 1.2, (B, K, 3)).astype(np.float32)
    scores = rng.choice([0.2, 0.5, 0.9], (B, K)).astype(np.float32)  # ties
    valid = rng.random((B, K)) < 0.8
    sem = rng.integers(0, 3, (B, K))
    bmin, bmax = torch.from_numpy(center - size / 2), \
        torch.from_numpy(center + size / 2)
    if cls_nms:
        shift = (torch.from_numpy(sem).float()
                 * (bmax.max() - bmin.min() + 1.0))[..., None]
        bmin, bmax = bmin + shift, bmax + shift
    iou = tboxes.aabb_iou_3d(bmin, bmax, bmin, bmax)
    args = (iou, torch.from_numpy(scores), torch.from_numpy(valid), thresh)
    before = cuda_nms.launches
    keep = library.greedy_suppress(*args)
    assert cuda_nms.launches == before
    assert torch.equal(keep, tops.plain.greedy_suppress(*args))
    jkeep = j_nms_aabb(jnp.asarray(center - size / 2),
                       jnp.asarray(center + size / 2), jnp.asarray(scores),
                       jnp.asarray(valid), thresh,
                       sem_cls=jnp.asarray(sem) if cls_nms else None)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


@pytest.mark.parametrize("b,k", [(3, 40), (2, 256)],
                         ids=["B3-K40", "B2-K256"])
@pytest.mark.parametrize("case", NMS_CASES,
                         ids=[nms_case_id(c) for c in NMS_CASES])
def test_walk_op_on_cpu_equals_jax_on_edge_cases(case, b, k):
    """The op on CPU tensors (the plain loop) keeps what the JAX package's
    walk keeps on the same IoU matrix: random boxes and IoU exactly at the
    fp32-rounded threshold (and one ulp either side) or NaN, at the
    thresholds 0.02, 0.25 and 0.99; tied scores, no candidate valid, none
    suppressed, one box repeated K times, NaN and signed-zero scores. The
    card holds the kernel to the plain loop on the same cases
    (tests/test_torch_nms_kernel.py)."""
    from tpu3dsad_torch.ops import library

    name, thresh = case
    iou, scores, valid = make_nms_case(name, b, k, thresh)
    keep = library.greedy_suppress(
        *map(torch.from_numpy, (iou, scores, valid)), thresh).numpy()
    jkeep = j_greedy_suppress(jnp.asarray(iou), jnp.asarray(scores),
                              jnp.asarray(valid), thresh)
    np.testing.assert_array_equal(keep, np.asarray(jkeep))
    if name == "all_invalid":
        assert not keep.any()
    elif name == "none_suppressed":
        np.testing.assert_array_equal(keep, valid)
    elif name == "repeated":
        assert (keep.sum(1) == valid.any(1)).all()  # the best one alone
    elif name == "random" and thresh <= 0.25:
        assert (keep.sum(1) < valid.sum(1)).any()  # some suppressed


def test_unported_options_raise(pair):
    """Density sampling, the lineage head and the BEV / oriented NMS,
    which this test once showed refused (hence its name), now run (held to the
    reference in test_torch_outdoor_train.py)."""
    _, _, _, pts, mask = pair
    for change in (dict(proposal_sampling="density"),
                   dict(proposal_mode="lineage")):
        model = SizeAdaptiveDetector(
            tconfig.ModelConfig(**{**dataclasses.asdict(to_port(SMALL)),
                                   **change}), device="cpu")
        with torch.no_grad():
            ep = model(torch.from_numpy(pts), mask=torch.from_numpy(mask))
        assert ep["proposal_inds"].shape == (2, SMALL.num_proposals)
        assert ("scale_logits" in ep) == ("proposal_mode" not in change)
        for ev in (EvalConfig(use_oriented_nms=True),
                   EvalConfig(use_3d_nms=False)):
            keep = parse_predictions(ep, model.mean_sizes, 12, ev)["keep"]
            assert 0 < keep.sum() < keep.numel()


@pytest.mark.parametrize("name", ["ModelConfig", "EvalConfig"])
def test_port_config_defaults_equal_reference(name):
    """Every field of the port's config exists in the reference's, with
    the same default, but 3DSSD's ssd3d_* and Group-Free 3D's groupfree_*
    fields, which are the port's alone."""
    port = getattr(tconfig, name)()
    ref = {"ModelConfig": ModelConfig, "EvalConfig": EvalConfig}[name]()
    for f in dataclasses.fields(port):
        if f.name in PORT_ONLY:
            assert not hasattr(ref, f.name), f.name
            continue
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert to_port(Config()) == tconfig.Config()


@pytest.mark.parametrize("num_classes", [1, 4, 10, 18])
def test_class_mean_sizes_equal_reference(num_classes):
    np.testing.assert_array_equal(tconfig.class_mean_sizes(num_classes),
                                  class_mean_sizes(num_classes))


def test_port_imports_without_jax():
    """Neither JAX nor any module of the JAX package is loaded, by the
    inference slice or by the parallel package (mesh, launch, collectives,
    the point-sharded ops)."""
    code = (
        "import sys\n"
        "import tpu3dsad_torch, tpu3dsad_torch.serving, tpu3dsad_torch.ops\n"
        "import tpu3dsad_torch.models.detector, tpu3dsad_torch.utils.bridge\n"
        "import tpu3dsad_torch.parallel, tpu3dsad_torch.parallel.launch\n"
        "import tpu3dsad_torch.parallel.point_sharded\n"
        "import tpu3dsad_torch.parallel.collectives\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'tpu3dsad')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
