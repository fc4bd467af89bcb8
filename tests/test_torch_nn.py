"""nn modules of the PyTorch port held against the flax modules on the CPU,
with the flax weights copied over by the bridge (tpu3dsad_torch.utils.bridge).

Tolerance rtol 1e-4, atol 1e-5: both sides run the same fp32 formulas, but
the matmuls sum in another order. FPS and ball-query indices are integers
and must be equal.
"""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3dsad.nn import FeaturePropagation as JFP
from tpu3dsad.nn import MaskedBatchNorm as JBN
from tpu3dsad.nn import SetAbstraction as JSA
from tpu3dsad.nn import SharedMLP as JMLP
from tpu3dsad_torch.nn import (
    FeaturePropagation,
    MaskedBatchNorm,
    SetAbstraction,
    SharedMLP,
)
from tpu3dsad_torch.utils.bridge import (
    load_flax_variables,
    state_dict_from_flax,
)

RTOL, ATOL = 1e-4, 1e-5


def randomize(variables, seed=0):
    """Fresh flax variables with BN statistics and affine params drawn at
    random, so BatchNorm is not the identity in these comparisons."""
    rng = np.random.default_rng(seed)
    out = flax.core.unfreeze(copy.deepcopy(variables))

    def walk(tree, col):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, col)
            elif col == "batch_stats":
                tree[k] = (rng.uniform(0.5, 2.0, v.shape) if k == "var"
                           else rng.normal(0, 0.5, v.shape)).astype(np.float32)
            elif k in ("scale", "bias"):
                tree[k] = rng.normal(1.0 if k == "scale" else 0.0, 0.3,
                                     v.shape).astype(np.float32)

    for col in out:
        walk(out[col], col)
    return out


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_masked_batchnorm_eval():
    x = np.random.default_rng(1).normal(size=(3, 7, 5)).astype(np.float32)
    jbn = JBN()
    var = randomize(jbn.init(jax.random.key(0), jnp.asarray(x), train=False))
    bn = MaskedBatchNorm(5).eval()
    load_flax_variables(bn, var)
    _close(bn(_t(x)), jbn.apply(var, jnp.asarray(x), train=False))


def test_masked_batchnorm_train_mode_is_not_ported():
    """Train mode, once left for the training slice, is ported now: the
    output and the updated running statistics equal flax's (masked cases
    are in test_torch_train.py)."""
    x = np.random.default_rng(5).normal(size=(2, 4)).astype(np.float32)
    jbn = JBN()
    var = randomize(jbn.init(jax.random.key(0), jnp.asarray(x), train=False))
    want, upd = jbn.apply(var, jnp.asarray(x), train=True, momentum=0.9,
                          mutable=["batch_stats"])
    bn = MaskedBatchNorm(4).train()
    load_flax_variables(bn, var)
    _close(bn(_t(x), momentum=0.9), want)
    _close(bn.running_mean, upd["batch_stats"]["mean"])
    _close(bn.running_var, upd["batch_stats"]["var"])


def test_shared_mlp():
    x = np.random.default_rng(2).normal(size=(2, 6, 4, 5)).astype(np.float32)
    jm = JMLP((8, 16))
    var = randomize(jm.init(jax.random.key(1), jnp.asarray(x)))
    mlp = SharedMLP(5, (8, 16)).eval()
    load_flax_variables(mlp, var)
    _close(mlp(_t(x)), jm.apply(var, jnp.asarray(x)))


@pytest.mark.parametrize("msg", [False, True])
def test_set_abstraction(msg):
    rng = np.random.default_rng(3)
    B, N, C = 2, 128, 4
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, 90:] = False
    kw = dict(npoint=24, radii=(0.3, 0.6) if msg else (0.4,),
              nsamples=(8, 16) if msg else (16,),
              mlps=((8, 16), (8, 8)) if msg else ((8, 16),),
              normalize_xyz=True)
    jsa = JSA(**kw)
    args = (jnp.asarray(xyz), jnp.asarray(feats))
    var = randomize(jsa.init(jax.random.key(2), *args,
                             mask=jnp.asarray(mask)), seed=3)
    jout = jsa.apply(var, *args, mask=jnp.asarray(mask))
    sa = SetAbstraction(in_features=C, **kw).eval()
    load_flax_variables(sa, var)
    with torch.no_grad():
        out = sa(_t(xyz), _t(feats), mask=_t(mask))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(jout[2]))  # inds
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(jout[3]))  # mask
    _close(out[0], jout[0])
    _close(out[1], jout[1])


def test_feature_propagation():
    rng = np.random.default_rng(4)
    dx = rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
    df = rng.normal(size=(2, 40, 6)).astype(np.float32)
    sx = rng.uniform(-1, 1, (2, 12, 3)).astype(np.float32)
    sf = rng.normal(size=(2, 12, 5)).astype(np.float32)
    smask = np.ones((2, 12), bool)
    smask[0, 8:] = False
    smask[1] = False  # all-invalid support: +inf distances become 1e10
    jfp = JFP(mlp=(16, 8))
    args = tuple(map(jnp.asarray, (dx, df, sx, sf)))
    var = randomize(jfp.init(jax.random.key(3), *args,
                             sparse_mask=jnp.asarray(smask)), seed=4)
    want = jfp.apply(var, *args, sparse_mask=jnp.asarray(smask))
    fp = FeaturePropagation(6 + 5, (16, 8)).eval()
    load_flax_variables(fp, var)
    with torch.no_grad():
        got = fp(*map(_t, (dx, df, sx, sf)), sparse_mask=_t(smask))
    _close(got, want)


def test_bridge_fills_every_key_and_consumes_every_leaf():
    jm = JMLP((8, 16))
    var = flax.core.unfreeze(jm.init(jax.random.key(1), jnp.zeros((1, 5))))
    mlp = SharedMLP(5, (8, 16))
    sd = state_dict_from_flax(var, mlp.state_dict())
    assert set(sd) == set(mlp.state_dict())
    # kernel [in, out] -> weight [out, in]
    np.testing.assert_array_equal(
        sd["dense_1.weight"].numpy(), np.asarray(var["params"]["dense_1"]["kernel"]).T)

    extra = copy.deepcopy(var)
    extra["params"]["dense_9"] = {"kernel": np.zeros((16, 4), np.float32)}
    with pytest.raises(KeyError, match="dense_9"):
        state_dict_from_flax(extra, mlp.state_dict())

    short = copy.deepcopy(var)
    del short["batch_stats"]["bn_0"]
    with pytest.raises(KeyError, match="bn_0.running_mean"):
        state_dict_from_flax(short, mlp.state_dict())

    with pytest.raises(ValueError, match="dense_0.weight"):
        state_dict_from_flax(var, SharedMLP(6, (8, 16)).state_dict())
