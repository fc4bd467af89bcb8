"""Public point-op API with kernel dispatch (tpu3dsad/ops/__init__.py).

FPS and ball query each exist twice behind this API: a hand-written CUDA
kernel (ops/cuda, the counterpart of the reference's impl='pallas') and its
plain PyTorch version (ops/plain, the counterpart of impl='xla'). Dispatch
goes by the tensor's device:

  * a CPU tensor takes the plain version;
  * a CUDA tensor launches the kernel, and a kernel that cannot be built or
    launched raises — there is no silent fallback;
  * the plain versions run on a CUDA tensor only when asked for by name,
    inside `with use_impl("plain"):` (to compare the two).

The other ops (gather/group, three_nn, three_interpolate) are XLA ops
outside any Pallas kernel in the reference, so they are plain PyTorch here.
"""

from __future__ import annotations

import contextlib

import torch

from tpu3dsad_torch.ops import plain as _plain
from tpu3dsad_torch.ops.cuda import ball_query as _cuda_bq
from tpu3dsad_torch.ops.cuda import fps as _cuda_fps
from tpu3dsad_torch.ops.masked import masked_max
from tpu3dsad_torch.ops.plain import (
    gather,
    group,
    interp_weights,
    three_interpolate,
    three_nn,
)

_VALID_IMPLS = ("auto", "plain")
_impl = "auto"


@contextlib.contextmanager
def use_impl(impl: str):
    """Run a block with FPS and ball query on `impl`, then restore."""
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
    """xyz [B,N,3] -> idx [B,npoint] int32. Seed index 0; mask-aware."""
    if _use_kernel(xyz):
        return _cuda_fps.furthest_point_sample(xyz, npoint, mask=mask)
    return _plain.furthest_point_sample(xyz, npoint, mask=mask)


def ball_query(xyz, centers, radius, nsample, *, mask=None):
    """-> (idx [B,M,K] int32, cnt [B,M] int32); pad-with-first-hit, exact."""
    if _use_kernel(xyz):
        return _cuda_bq.ball_query(xyz, centers, radius, nsample, mask=mask)
    return _plain.ball_query(xyz, centers, radius, nsample, mask=mask)


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
    "three_interpolate",
    "three_nn",
    "use_impl",
]
