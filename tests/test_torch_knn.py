"""The port's public ops.knn (tpu3dsad_torch/ops/plain/knn.py) held
against the reference's tpu3dsad.ops.knn(..., impl="xla") and the numpy
oracle (tpu3dsad/ops/oracle.py::knn_oracle), on the CPU.

Tolerances: idx exactly equal (ties to the lower support index, masked
supports last); d2 within rtol 1e-5, atol 1e-6 (both form
|a|^2 + |b|^2 - 2ab in fp32 with a full-fp32 cross term, summed in
possibly different orders). The slab scan above _SLAB_LIMIT distances is
checked by lowering both modules' _SLAB_LIMIT inside the test, so the
reference scans too at these sizes.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# six pytest-xdist workers share 8 cores: one intra-op thread each
torch.set_num_threads(1)

from tpu3dsad import ops as jops
from tpu3dsad.ops.oracle import knn_oracle
from tpu3dsad_torch import ops

# the modules (their packages' `knn` attributes are the functions)
j_knn_mod = importlib.import_module("tpu3dsad.ops.xla.knn")
t_knn_mod = importlib.import_module("tpu3dsad_torch.ops.plain.knn")

RTOL, ATOL = 1e-5, 1e-6


def both(query, support, k, mask=None):
    """((d2, idx) of the port, (d2, idx) of the reference) as numpy."""
    t_mask = None if mask is None else torch.from_numpy(mask)
    d2, idx = ops.knn(torch.from_numpy(query), torch.from_numpy(support), k,
                      support_mask=t_mask)
    assert d2.dtype == torch.float32 and idx.dtype == torch.int32
    jd2, jidx = jops.knn(jnp.asarray(query), jnp.asarray(support), k,
                         support_mask=None if mask is None
                         else jnp.asarray(mask), impl="xla")
    return (d2.numpy(), idx.numpy()), (np.asarray(jd2), np.asarray(jidx))


def require_equal(port, ref, query, support, k, mask=None):
    (d2, idx), (jd2, jidx) = port, ref
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(d2, jd2, rtol=RTOL, atol=ATOL)
    for b in range(len(query)):
        od2, oidx = knn_oracle(query[b], support[b], k,
                               None if mask is None else mask[b])
        np.testing.assert_array_equal(idx[b], oidx)
        np.testing.assert_allclose(d2[b], od2, rtol=RTOL, atol=ATOL)


def cloud(seed, b, m, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (b, m, 3)).astype(np.float32),
            rng.uniform(-1, 1, (b, n, 3)).astype(np.float32))


@pytest.mark.parametrize("slab_limit", [None, 4096])
@pytest.mark.parametrize("k", [1, 3, 16])
def test_knn_random_clouds_equal_reference(monkeypatch, slab_limit, k):
    """At slab_limit 4096 both scan [2, 40, 300] in slabs of 51 supports
    (the last one short)."""
    if slab_limit is not None:
        monkeypatch.setattr(t_knn_mod, "_SLAB_LIMIT", slab_limit)
        monkeypatch.setattr(j_knn_mod, "_SLAB_LIMIT", slab_limit)
    query, support = cloud(k, 2, 40, 300)
    require_equal(*both(query, support, k), query, support, k)


@pytest.mark.parametrize("slab_limit", [None, 2048])
def test_knn_ties_go_to_the_lower_index(monkeypatch, slab_limit):
    """Every support repeated 4 times along N (and across slab edges under
    the scan): each query's k = 8 nearest come as the lowest copies."""
    if slab_limit is not None:
        monkeypatch.setattr(t_knn_mod, "_SLAB_LIMIT", slab_limit)
        monkeypatch.setattr(j_knn_mod, "_SLAB_LIMIT", slab_limit)
    query, base = cloud(7, 2, 32, 50)
    support = np.concatenate([base] * 4, axis=1)
    port, ref = both(query, support, 8)
    require_equal(port, ref, query, support, 8)
    idx = port[1]
    np.testing.assert_array_equal(idx[..., :4],
                                  idx[..., :1] + np.arange(4) * 50)
    np.testing.assert_array_equal(idx[..., 4:],
                                  idx[..., 4:5] + np.arange(4) * 50)


@pytest.mark.parametrize("slab_limit", [None, 3000])
@pytest.mark.parametrize("k", [4, 16])
def test_knn_masked_supports_equal_reference(monkeypatch, slab_limit, k):
    """A masked tail and scattered masked supports are never picked while
    k valid ones remain; cloud 1 has fewer than k valid supports, whose
    masked picks sit at +inf in the reference's order."""
    if slab_limit is not None:
        monkeypatch.setattr(t_knn_mod, "_SLAB_LIMIT", slab_limit)
        monkeypatch.setattr(j_knn_mod, "_SLAB_LIMIT", slab_limit)
    query, support = cloud(11, 2, 24, 120)
    rng = np.random.default_rng(12)
    mask = rng.random((2, 120)) > 0.3
    mask[0, 90:] = False
    mask[1] = False
    mask[1, [5, 70]] = True
    port, ref = both(query, support, k, mask)
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_allclose(port[0], ref[0], rtol=RTOL, atol=ATOL)
    assert mask[0][port[1][0]].all()
    assert np.isinf(port[0][1][:, 2:]).all()
    require_equal(port, ref, query[:1], support[:1], k, mask[:1])


def test_knn_slab_scan_equals_direct(monkeypatch):
    """The port's scan equals its direct path on the same inputs (the
    check chip_smoke.py makes at [2, 16384, 16384])."""
    query, support = cloud(13, 2, 64, 500)
    q, s = torch.from_numpy(query), torch.from_numpy(support)
    d_direct, i_direct = ops.knn(q, s, 16)
    monkeypatch.setattr(t_knn_mod, "_SLAB_LIMIT", 64 * 2 * 37)
    d_scan, i_scan = ops.knn(q, s, 16)
    torch.testing.assert_close(i_scan, i_direct, rtol=0, atol=0)
    torch.testing.assert_close(d_scan, d_direct, rtol=0, atol=0)
