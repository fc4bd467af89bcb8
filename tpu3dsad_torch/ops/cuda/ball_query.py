"""Wrappers of csrc/ball_query.cu:

  * `ball_query` (entry tpu3dsad_ball_query) replaces the Pallas TPU kernel
    tpu3dsad/ops/pallas/ball_query.py::_kernel: the exact tier (B3), and,
    given the two sort permutations, the scan of the sorted tier (B4,
    ops/sorted.py) with its map-back fused into the epilogue;
  * `morton_codes` (entry tpu3dsad_morton_codes) computes the sorted tier's
    Z-order keys, bitwise ops/sorted.py's plain version.

`plan` chooses the scan's launch shape, a pure function of (B, N, M, K, SM
count, whether the views are in Z order) that the CPU tests pin. `launches` counts ball-query calls made by
this wrapper (each a pre-pass and a scan, counted once), so a run can show
that its main path went through the kernel; `last_plan` is the plan of the
last one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu3dsad_torch.ops.args import check_ball_query
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda.common import mask_arg, points_arg, ptr, stream
from tpu3dsad_torch.ops.plain.ball_query import radius_sq

TILE = 32  # points a tile, one per lane; a box per tile
CENTERS = (1, 2, 4)  # centers a warp: the kernel's template instances
MAX_WARPS = 16
# the reference's slack on the box test (ball_query.py::_tile_skip)
SKIP_SLACK = 1e-3
# register-block centers only while the card keeps this many warps an SM
MIN_WARPS_PER_SM = 16


class Plan(NamedTuple):
    """One launch shape of the scan: `warps` warps a block, `centers`
    centers a warp; `shared` stages the tiles a block needs in shared
    memory, else each warp loads its own from global memory."""
    warps: int
    centers: int
    shared: bool

    def __str__(self) -> str:
        loads = "shared" if self.shared else "global"
        return f"{self.warps} warps x {self.centers} centers, {loads} loads"


launches = 0
last_plan: Plan | None = None


def plan(b: int, n: int, m: int, k: int, sms: int,
         ordered: bool = False) -> Plan:
    """The scan's shape for b clouds of n points, m centers and K = k on a
    card of `sms` SMs (`ordered`: the sorted tier's Z-order views): 16
    warps a block, the most centers a warp that still leave
    MIN_WARPS_PER_SM warps an SM. In index order the warps of a block need
    mostly the same tiles, which the block stages in shared memory once; in
    Z order they need few and different ones, loaded from global memory
    (measured: PERF.md)."""
    c = max((c for c in CENTERS if b * m >= c * MIN_WARPS_PER_SM * sms),
            default=1)
    return Plan(16, c, not ordered)


def scratch_floats(b: int, n: int) -> int:
    """fp32 words of the pre-pass's scratch: the staged points [B, 3, T*32]
    and the tile boxes [B, 6, T], T = ceil(n / 32)."""
    tiles = -(-n // TILE)
    return b * (3 * tiles * TILE + 6 * tiles)


def skip_radius_sq(r2: float) -> float:
    """The box test's fp32 threshold: a tile is skipped where its squared
    separation from the center exceeds r2 * (1 + SKIP_SLACK) >= r2."""
    return float(np.float32(float(r2) * (1.0 + SKIP_SLACK)))


def _perm_arg(t: torch.Tensor, shape: tuple, name: str,
              device: torch.device) -> torch.Tensor:
    if t.device != device or t.dtype != torch.int64 or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be int64 {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               nsample: int, mask: torch.Tensor | None = None, *,
               perm: torch.Tensor | None = None,
               perm_c: torch.Tensor | None = None,
               launch: Plan | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """xyz [B,N,3], centers [B,M,3] fp32 CUDA -> (idx [B,M,K] int32,
    cnt [B,M] int32). With perm [B,N] and perm_c [B,M] (int64 sort
    permutations, the sorted tier) the scan runs on the views xyz[perm],
    centers[perm_c] and the results come back in the caller's point
    indices and center order. `launch` overrides plan()."""
    global launches, last_plan
    check_ball_query(xyz, centers, nsample, mask)
    xyz = points_arg(xyz, "xyz")
    centers = points_arg(centers, "centers")
    valid = mask_arg(mask, xyz)
    B, N, _ = xyz.shape
    M = centers.shape[1]
    if centers.device != xyz.device:
        raise ValueError(f"centers must be on {xyz.device}")
    if (perm is None) != (perm_c is None):
        raise ValueError("perm and perm_c go together")
    if perm is not None:
        perm = _perm_arg(perm, (B, N), "perm", xyz.device)
        perm_c = _perm_arg(perm_c, (B, M), "perm_c", xyz.device)
    if launch is None:
        sms = torch.cuda.get_device_properties(xyz.device).multi_processor_count
        launch = plan(B, N, M, nsample, sms, ordered=perm is not None)
    lib = build.library()
    scratch = torch.empty(scratch_floats(B, N), dtype=torch.float32,
                          device=xyz.device)
    idx = torch.empty(B, M, nsample, dtype=torch.int32, device=xyz.device)
    cnt = torch.empty(B, M, dtype=torch.int32, device=xyz.device)
    r2 = radius_sq(radius)
    with torch.cuda.device(xyz.device):
        err = lib.tpu3dsad_ball_query(
            ptr(xyz), ptr(valid), ptr(centers), ptr(perm), ptr(perm_c),
            ptr(scratch), ptr(idx), ptr(cnt), B, N, M, nsample, r2,
            skip_radius_sq(r2), launch.warps, launch.centers,
            int(launch.shared), stream(xyz))
    build.check(err, "tpu3dsad_ball_query")
    launches += 1
    last_plan = launch
    return idx, cnt


def morton_codes(xyz: torch.Tensor, centers: torch.Tensor,
                 mask: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """xyz [B,N,3], centers [B,M,3] fp32 CUDA -> (codes_x [B,N] int32,
    codes_c [B,M] int32): Z-order keys on the 256^3 grid anchored to the
    valid points' bounding box, 1 << 30 for invalid points."""
    check_ball_query(xyz, centers, 1, mask)
    xyz = points_arg(xyz, "xyz")
    centers = points_arg(centers, "centers")
    valid = mask_arg(mask, xyz)
    B, N, _ = xyz.shape
    M = centers.shape[1]
    lib = build.library()
    codes_x = torch.empty(B, N, dtype=torch.int32, device=xyz.device)
    codes_c = torch.empty(B, M, dtype=torch.int32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        err = lib.tpu3dsad_morton_codes(ptr(xyz), ptr(valid), ptr(centers),
                                        ptr(codes_x), ptr(codes_c), B, N, M,
                                        stream(xyz))
    build.check(err, "tpu3dsad_morton_codes")
    return codes_x, codes_c
