"""Public point-op API with kernel dispatch (tpu3dsad/ops/__init__.py).

FPS, feature FPS, ball query and the row scatter-add each exist twice
behind this API: a hand-written CUDA kernel (ops/cuda, the counterpart of
the reference's impl='pallas'; feature FPS, 3DSSD's, has none there) and
its plain PyTorch version (ops/plain, the counterpart of impl='xla'). FPS,
feature FPS and ball query (with the sorted tier's Morton codes) are
reached through the custom operators of ops/library.py, so that
torch.export keeps each call as one node. Dispatch goes by the tensor's
device:

  * a CPU tensor takes the plain version;
  * a CUDA tensor launches the kernel, and a kernel that cannot be built or
    launched raises — there is no silent fallback;
  * the plain versions run on a CUDA tensor only when asked for by name,
    inside `with use_impl("plain"):` (to compare the two).

gather and group are torch.gather forward, as in the reference's XLA tier;
their backward is `scatter_rows` (the role of ops/xla/group.py's
_make_take_rows with the 'pallas' scatter), so every gather/group/
three_interpolate whose source needs a gradient runs the scatter kernel in
a backward pass on the card. knn and three_nn are plain PyTorch on every
device: the reference's are XLA functions, outside any Pallas kernel.

Grouping is exact (first K in index order) unless fast grouping is on
(`set_fast_grouping`, or `exact=False` per call), as in the reference's
tpu3dsad/ops/__init__.py:23-57, with its two fast modes:

  * 'sorted' runs `ops.sorted.sorted_ball_query` (the exact tier on
    Z-order-sorted views: exact membership and counts, spatial slot order)
    where the reference's Pallas tier would: N >= sorted.SORTED_MIN_N,
    K % 8 == 0, K <= N. Below that gate the reference falls to its
    approx_max_k tier; the port groups exactly there;
  * 'approx' (lax.approx_max_k, the reference's default) exists only on
    the TPU and raises NotImplementedError; it never quietly groups
    exactly instead.

The port's default is exact grouping (Config.ops_fast_grouping=False).
"""

from __future__ import annotations

import contextlib

import torch

from tpu3dsad_torch.ops import library as _library
from tpu3dsad_torch.ops import plain as _plain
from tpu3dsad_torch.ops import sorted as _sorted
from tpu3dsad_torch.ops.cuda import scatter as _cuda_scatter
from tpu3dsad_torch.ops.masked import masked_max
from tpu3dsad_torch.ops.plain import interp_weights, three_nn
from tpu3dsad_torch.ops.plain.knn import knn as _plain_knn

_VALID_IMPLS = ("auto", "plain")
_impl = "auto"
_VALID_FAST_MODES = ("approx", "sorted")
_exact_grouping = True
_fast_mode = "approx"


def set_fast_grouping(fast: bool) -> None:
    """Group with the fast tier of get_fast_mode() where exact is not
    asked for per call (module docstring)."""
    global _exact_grouping
    _exact_grouping = not fast


def get_fast_grouping() -> bool:
    return not _exact_grouping


def set_fast_mode(mode: str) -> None:
    """'sorted' (ops/sorted.py) or 'approx' (TPU only, refused at use)."""
    global _fast_mode
    if mode not in _VALID_FAST_MODES:
        raise ValueError(
            f"fast mode must be one of {_VALID_FAST_MODES}, got {mode!r}")
    _fast_mode = mode


def get_fast_mode() -> str:
    return _fast_mode


@contextlib.contextmanager
def use_impl(impl: str):
    """Run a block with the kernel ops on `impl`, then restore."""
    global _impl
    if impl not in _VALID_IMPLS:
        raise ValueError(f"impl must be one of {_VALID_IMPLS}, got {impl!r}")
    old, _impl = _impl, impl
    try:
        yield
    finally:
        _impl = old


def _use_kernel(t: torch.Tensor) -> bool:
    if _impl == "plain" or t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {t.device}; use_impl('plain')")


def furthest_point_sample(xyz, npoint, *, mask=None):
    """xyz [B,N,3] -> idx [B,npoint] int32. Seed index 0; mask-aware.
    The picks are integers outside the autograd graph."""
    return _library.fps(xyz.detach(), npoint, mask)


def feature_furthest_point_sample(points, npoint, *, mask=None):
    """points [B,N,D] -> idx [B,npoint] int32: FPS by the fp32 squared
    distance over each point's whole vector (3DSSD's F-FPS; xyz and its
    features), seed index 0, ties to the lowest index; mask-aware. The
    picks are integers outside the autograd graph."""
    return _library.ffps(points.detach(), npoint, mask)


def _sorted_tier(xyz, nsample, exact) -> bool:
    """Whether this call takes the sorted tier; raises for 'approx'."""
    if _exact_grouping if exact is None else exact:
        return False
    if _fast_mode == "approx":
        raise NotImplementedError(
            "fast grouping with ops_fast_mode='approx' is lax.approx_max_k, "
            "which is specific to the TPU and not ported; use "
            "ops_fast_mode='sorted' or exact grouping")
    return _sorted.applies(xyz.shape[1], nsample)


def ball_query(xyz, centers, radius, nsample, *, mask=None, exact=None):
    """-> (idx [B,M,K] int32, cnt [B,M] int32); pad-with-first-hit. Exact
    first-K in index order, or the sorted tier under fast grouping
    (module docstring; exact=None follows set_fast_grouping). Both are
    integers outside the autograd graph."""
    xyz, centers = xyz.detach(), centers.detach()
    if _sorted_tier(xyz, nsample, exact):
        return _sorted.sorted_ball_query(xyz, centers, radius, nsample,
                                         mask=mask)
    return _library.ball_query(xyz, centers, radius, nsample, mask)


def knn(query, support, k, *, support_mask=None):
    """-> (d2 [B,M,k] fp32, idx [B,M,k] int32): the k nearest valid
    supports, ties to the lower index; masked supports sit at +inf.
    Above 2^28 distances the support is scanned in slabs
    (ops/plain/knn.py)."""
    return _plain_knn(query, support, k, support_mask)


def box_points(points, centers, sizes, *, mask=None):
    """-> counts [B,P] int32: the valid points of points [B,N,3] inside
    each axis-aligned box of centers and sizes [B,P,3] (strict faces in x
    and y, an inclusive face in z: ops/plain/box_points.py); integers
    outside the autograd graph."""
    return _library.box_points(points.detach(), centers.detach(),
                               sizes.detach(), mask)


def scatter_rows(g, idx, n):
    """g [B,U,C], idx [B,U] int -> [B,n,C] fp32: out[b, idx[b,u]] += g[b,u];
    indices < 0 or >= n add nothing."""
    if _use_kernel(g):
        return _cuda_scatter.scatter_rows(g, idx, n)
    return _plain.scatter_rows(g, idx, n)


class _TakeRows(torch.autograd.Function):
    """points [B,N,C], idx [B,U] -> points[b, idx[b,u]]; the gradient of
    points is scatter_rows of the output's gradient."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return _plain.gather(points, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return scatter_rows(grad, idx, ctx.n).to(grad.dtype), None


def gather(points, idx):
    """points [B,N,C], idx [B,M] -> [B,M,C] (backward: scatter_rows)."""
    return _TakeRows.apply(points, idx)


def group(points, idx):
    """points [B,N,C], idx [B,M,K] -> [B,M,K,C] (backward: scatter_rows)."""
    B, M, K = idx.shape
    return gather(points, idx.reshape(B, M * K)).reshape(B, M, K, -1)


def three_interpolate(feats, idx, weight):
    """feats [B,N,C], idx [B,M,3], weight [B,M,3] -> [B,M,C]."""
    return torch.einsum("bmkc,bmk->bmc", group(feats, idx), weight)


def query_and_group(xyz, centers, radius, nsample, *, features=None,
                    mask=None, use_xyz=True, normalize_xyz=False, exact=None):
    """Ball query, then one gather of xyz (+features) around each center.

    Returns (grouped [B,M,K,3+C or C or 3], idx [B,M,K], group_mask [B,M,K]);
    grouped xyz is center-relative, divided by the radius if
    `normalize_xyz`; group_mask marks slots < cnt. `exact` as in
    ball_query."""
    idx, cnt = ball_query(xyz, centers, radius, nsample, mask=mask,
                          exact=exact)
    src = xyz if features is None else torch.cat([xyz, features], -1)
    grouped, group_mask = _plain.group_epilogue(
        group(src, idx), centers, cnt, radius, nsample,
        has_features=features is not None, use_xyz=use_xyz,
        normalize_xyz=normalize_xyz,
    )
    return grouped, idx, group_mask


__all__ = [
    "ball_query",
    "box_points",
    "feature_furthest_point_sample",
    "furthest_point_sample",
    "gather",
    "get_fast_grouping",
    "get_fast_mode",
    "group",
    "interp_weights",
    "knn",
    "masked_max",
    "query_and_group",
    "scatter_rows",
    "set_fast_grouping",
    "set_fast_mode",
    "three_interpolate",
    "three_nn",
    "use_impl",
]
