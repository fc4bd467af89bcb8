"""Context parallelism of the port's detector (SizeAdaptiveDetector with
cp_mesh, model.cp_stages) held against its own unsharded forward and the
JAX package's, on the CPU, as tests/distributed/test_sharded_model_path.py:
140-180 holds the reference: B = 2 scenes of 512 points with a masked tail
from 500, cp_stages = 2, over a ('points',) mesh of 2 gloo ranks started
once for the file (test_torch_parallel_workers.cp_ranks).

Against the port's unsharded forward the outputs are bitwise equal (CP
groups exactly, and the port always does). Against the JAX forward from
the same bridged weights: indices equal, floats at rtol 1e-4, atol 1e-5
(tests/test_torch_detector.py's bar: fp32 matmuls summed in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from tpu3dsad.config import ModelConfig
from tpu3dsad.models.detector import SizeAdaptiveDetector as JDetector
from tpu3dsad_torch.config import Config
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.parallel import launch
from tpu3dsad_torch.utils.bridge import load_flax_variables

import test_torch_parallel_workers as workers
from test_torch_detector import to_port
from test_torch_nn import randomize

WORLD = 2
RTOL, ATOL = 1e-4, 1e-5
CP = ModelConfig(
    num_classes=4,
    sa_npoints=(64, 32, 16, 8),
    sa_nsamples=(8, 8, 4, 4),
    sa_channels=((16, 16), (16, 32), (16, 32), (16, 32)),
    fp_channels=((32, 32), (32, 32)),
    seed_feat_dim=32,
    num_proposals=16,
    cluster_nsample=4,
    cp_stages=2,
)
KEYS = ("seed_inds", "seed_xyz", "proposal_inds", "proposal_xyz",
        "raw_params", "objectness_scores")
INDICES = ("seed_inds", "proposal_inds")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, (2, 512, 3)).astype(np.float32)
    mask = np.ones((2, 512), bool)
    mask[:, 500:] = False
    jm = JDetector(CP)
    var = jax.jit(lambda k: jm.init(k, jnp.asarray(pts),
                                    mask=jnp.asarray(mask), train=False))(
        jax.random.key(0))
    # trained-looking BatchNorm statistics and scales, so eval mode is not
    # the identity
    var = jax.tree.map(np.asarray, randomize(var, seed=3))
    return {"cfg": Config(model=to_port(CP)), "variables": var,
            "points": pts, "mask": mask, "keys": KEYS, "jmodel": jm}


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    init = tmp_path_factory.mktemp("rendezvous") / "file"
    sent = {k: v for k, v in case.items() if k != "jmodel"}
    return launch.spawn(workers.cp_ranks, WORLD, backend="gloo",
                        init_file=str(init), args=(sent,))


@pytest.fixture(scope="module")
def unsharded(case):
    model = SizeAdaptiveDetector(case["cfg"].model, device="cpu")
    load_flax_variables(model, case["variables"])
    with torch.no_grad():
        ep = model(torch.from_numpy(case["points"]),
                   mask=torch.from_numpy(case["mask"]))
    return {k: ep[k].numpy() for k in KEYS}


@pytest.fixture(scope="module")
def reference(case):
    ep = jax.jit(lambda p, m: case["jmodel"].apply(
        case["variables"], p, mask=m, train=False))(
            jnp.asarray(case["points"]), jnp.asarray(case["mask"]))
    return {k: np.asarray(ep[k]) for k in KEYS}


@pytest.mark.parametrize("key", KEYS)
def test_cp_forward_is_bitwise_the_unsharded_forward(ranks, unsharded, key):
    for r in ranks:
        np.testing.assert_array_equal(r["end_points"][key], unsharded[key],
                                      err_msg=key)


@pytest.mark.parametrize("key", KEYS)
def test_cp_forward_matches_reference(ranks, reference, key):
    got = ranks[0]["end_points"][key]
    if key in INDICES:
        np.testing.assert_array_equal(got, reference[key])
    else:
        np.testing.assert_allclose(got, reference[key], rtol=RTOL,
                                   atol=ATOL)


def test_cp_forward_collectives(ranks):
    """SA1 and SA2 sharded: per level one collective a pick and one for
    the seed (FPS), one for the centers, two for the ball query and the
    grouping; nothing after them."""
    picks = sum(n for n in CP.sa_npoints[:CP.cp_stages])
    want = picks + CP.cp_stages * 3
    assert [r["collectives"] for r in ranks] == [want] * WORLD
