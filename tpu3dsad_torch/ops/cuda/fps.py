"""Wrappers of the two FPS kernels of csrc/fps.cu:

  * `fps_batched` (B1), one block per cloud, replaces the Pallas TPU kernel
    tpu3dsad/ops/pallas/fps.py::_fps_kernel;
  * `fps_flat` (B2), one thread-block cluster for one large cloud, replaces
    tpu3dsad/ops/pallas/fps.py::_fps_kernel_flat.

`furthest_point_sample` takes B2 for one cloud (B == 1) of more than
FLAT_MIN_N points, as the reference does (fps.py:229-231), and B1 for the
rest. The reference drops to its XLA tier above MAX_FLAT_ELEMS for lack of
TPU VMEM; the cluster kernel has no upper size, so the port has no third
tier.

`launches` counts B1 launches and `flat_launches` B2 launches made by these
wrappers, so a run can show which kernel its main path went through;
`last_cluster` is the cluster size of the last B2 launch.
"""

from __future__ import annotations

import ctypes

import torch

from tpu3dsad_torch.ops.args import check_fps
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda.common import mask_arg, points_arg, ptr, stream

FLAT_MIN_N = 65536  # the reference's MAX_KERNEL_N

launches = 0
flat_launches = 0
last_cluster = 0


def furthest_point_sample(xyz: torch.Tensor, npoint: int,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """xyz [B, N, 3] fp32 CUDA (+mask [B, N]) -> idx [B, npoint] int32."""
    if xyz.dim() == 3 and xyz.shape[0] == 1 and xyz.shape[1] > FLAT_MIN_N:
        return fps_flat(xyz, npoint, mask)
    return fps_batched(xyz, npoint, mask)


def fps_batched(xyz: torch.Tensor, npoint: int,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """B1 at any B and N: one block per cloud."""
    global launches
    check_fps(xyz, npoint, mask)
    xyz = points_arg(xyz, "xyz")
    valid = mask_arg(mask, xyz)
    B, N, _ = xyz.shape
    lib = build.library()
    idx = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    dist = torch.empty(B, N, dtype=torch.float32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        err = lib.tpu3dsad_fps(ptr(xyz), ptr(valid), ptr(dist), ptr(idx),
                               B, N, npoint, stream(xyz))
    build.check(err, "tpu3dsad_fps")
    launches += 1
    return idx


def fps_flat(xyz: torch.Tensor, npoint: int,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """B2 for one cloud (B == 1) of any N: one thread-block cluster."""
    global flat_launches, last_cluster
    check_fps(xyz, npoint, mask)
    if xyz.shape[0] != 1:
        raise ValueError(f"fps_flat takes one cloud, got B={xyz.shape[0]}")
    xyz = points_arg(xyz, "xyz")
    valid = mask_arg(mask, xyz)
    N = xyz.shape[1]
    lib = build.library()
    idx = torch.empty(1, npoint, dtype=torch.int32, device=xyz.device)
    dist = torch.empty(N, dtype=torch.float32, device=xyz.device)
    cluster = ctypes.c_int(0)
    with torch.cuda.device(xyz.device):
        err = lib.tpu3dsad_fps_flat(ptr(xyz), ptr(valid), ptr(dist), ptr(idx),
                                    N, npoint, ctypes.byref(cluster),
                                    stream(xyz))
    build.check(err, "tpu3dsad_fps_flat")
    flat_launches += 1
    last_cluster = cluster.value
    return idx
