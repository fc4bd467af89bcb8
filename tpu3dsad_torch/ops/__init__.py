"""Public point-op API with kernel dispatch (tpu3dsad/ops/__init__.py).

FPS, ball query and the row scatter-add each exist twice behind this API:
a hand-written CUDA kernel (ops/cuda, the counterpart of the reference's
impl='pallas') and its plain PyTorch version (ops/plain, the counterpart of
impl='xla'). Dispatch goes by the tensor's device:

  * a CPU tensor takes the plain version;
  * a CUDA tensor launches the kernel, and a kernel that cannot be built or
    launched raises — there is no silent fallback;
  * the plain versions run on a CUDA tensor only when asked for by name,
    inside `with use_impl("plain"):` (to compare the two).

gather and group are torch.gather forward, as in the reference's XLA tier;
their backward is `scatter_rows` (the role of ops/xla/group.py's
_make_take_rows with the 'pallas' scatter), so every gather/group/
three_interpolate whose source needs a gradient runs the scatter kernel in
a backward pass on the card. three_nn is plain PyTorch, outside any Pallas
kernel in the reference.
"""

from __future__ import annotations

import contextlib

import torch

from tpu3dsad_torch.ops import plain as _plain
from tpu3dsad_torch.ops.cuda import ball_query as _cuda_bq
from tpu3dsad_torch.ops.cuda import fps as _cuda_fps
from tpu3dsad_torch.ops.cuda import scatter as _cuda_scatter
from tpu3dsad_torch.ops.masked import masked_max
from tpu3dsad_torch.ops.plain import interp_weights, three_nn

_VALID_IMPLS = ("auto", "plain")
_impl = "auto"


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
    xyz = xyz.detach()
    if _use_kernel(xyz):
        return _cuda_fps.furthest_point_sample(xyz, npoint, mask=mask)
    return _plain.furthest_point_sample(xyz, npoint, mask=mask)


def ball_query(xyz, centers, radius, nsample, *, mask=None):
    """-> (idx [B,M,K] int32, cnt [B,M] int32); pad-with-first-hit, exact.
    Both are integers outside the autograd graph."""
    xyz, centers = xyz.detach(), centers.detach()
    if _use_kernel(xyz):
        return _cuda_bq.ball_query(xyz, centers, radius, nsample, mask=mask)
    return _plain.ball_query(xyz, centers, radius, nsample, mask=mask)


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
                    mask=None, use_xyz=True, normalize_xyz=False):
    """Ball query, then one gather of xyz (+features) around each center.

    Returns (grouped [B,M,K,3+C or C or 3], idx [B,M,K], group_mask [B,M,K]);
    grouped xyz is center-relative, divided by the radius if
    `normalize_xyz`; group_mask marks slots < cnt."""
    idx, cnt = ball_query(xyz, centers, radius, nsample, mask=mask)
    src = xyz if features is None else torch.cat([xyz, features], -1)
    grouped, group_mask = _plain.group_epilogue(
        group(src, idx), centers, cnt, radius, nsample,
        has_features=features is not None, use_xyz=use_xyz,
        normalize_xyz=normalize_xyz,
    )
    return grouped, idx, group_mask


__all__ = [
    "ball_query",
    "furthest_point_sample",
    "gather",
    "group",
    "interp_weights",
    "masked_max",
    "query_and_group",
    "scatter_rows",
    "three_interpolate",
    "three_nn",
    "use_impl",
]
