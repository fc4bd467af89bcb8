"""Wrappers of the FPS kernel template of csrc/fps.cu, one thread-block
cluster per cloud, through its two C entries:

  * `fps_batched` (B1, entry tpu3dsad_fps) replaces the Pallas TPU kernel
    tpu3dsad/ops/pallas/fps.py::_fps_kernel;
  * `fps_flat` (B2, entry tpu3dsad_fps_flat, one cloud) replaces
    tpu3dsad/ops/pallas/fps.py::_fps_kernel_flat.

`furthest_point_sample` takes B2 for one cloud (B == 1) of more than
FLAT_MIN_N points, as the reference does (fps.py:229-231), and B1 for the
rest. The reference drops to its XLA tier above MAX_FLAT_ELEMS for lack of
TPU VMEM; the kernel has no upper size, so the port has no third tier.

`plan` chooses the launch shape, a pure function of (B, N, SM count) that
the CPU tests pin. B2 at 16 points a thread (every plan() of more than
65536 and up to 131072 points) runs the pruned pass of csrc/fps.cu: its
pre-pass `slab_order` deals the points into spatially compact slabs of
SLAB points, one a warp (Z-order keys, `deal`), and a warp skips each
round whose pick provably lowers no distance in its slab; the picks are
the unpruned kernel's, bit for bit.

`launches` counts B1 launches and `flat_launches` B2 launches made by
these wrappers, so a run can show which entry its main path went
through; `flat_points` sums the points (N, padding included) each B2
launch was given, which varies with a scan's crop; `last_plan` is the
plan of the last launch of either, `last_cluster` the cluster size of the
last B2 launch. `flat_clusters` is how many B2 clusters the card runs at
once, which sizes the KITTI fit's pool of side streams (data/kitti.py).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from tpu3dsad_torch.ops.args import check_fps
from tpu3dsad_torch.ops.cuda import ball_query as cuda_bq
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda.common import mask_arg, points_arg, ptr, stream

FLAT_MIN_N = 65536  # the reference's MAX_KERNEL_N
# points a thread holds in registers -> the most threads a CTA may have:
# the template instances of fps.cu and their launch bounds (no shape of the
# main paths ran faster at 4 points a thread than at 2 or 8: PERF.md)
REGISTER_TIERS = {1: 1024, 2: 1024, 8: 1024, 16: 512}
MAX_THREADS = 1024
MAX_PORTABLE = 8  # clusters above 8 CTAs are non-portable, and slower
MAX_CLUSTER = 16  # the largest (non-portable) cluster on Hopper
# a round's fixed cost grows with the warps of a CTA and its pass with the
# points a thread: a slice takes the fewest points a thread that fit it in
# MIN_THREADS threads (past that, the fewest threads), and a cloud is split
# across CTAs down to MIN_SLICE points a CTA (measured: PERF.md)
MIN_THREADS = 128
MIN_SLICE = 128
# B2's pruned pass: the points a thread holds, and a warp's slab of them
PRUNED_POINTS = 16
SLAB = 32 * PRUNED_POINTS
# the largest cloud it holds: MAX_CLUSTER CTAs of its most threads
PRUNED_MAX = MAX_CLUSTER * REGISTER_TIERS[PRUNED_POINTS] * PRUNED_POINTS


class Plan(NamedTuple):
    """One launch shape: `cluster` CTAs of `threads` threads per cloud,
    each thread holding `points` points in registers (0: the memory
    tier, points in global memory)."""
    cluster: int
    threads: int
    points: int

    @property
    def tier(self) -> str:
        return f"registers x{self.points}" if self.points else "memory"


launches = 0
flat_launches = 0
flat_points = 0
last_plan: Plan | None = None
last_cluster = 0


def register_plan(c: int, n: int) -> Plan | None:
    """The register-tier shape of c CTAs for n points: the fewest points a
    thread that fit a CTA's slice in MIN_THREADS threads, else the fewest
    threads (a multiple of 32) at any tier; None past the register tiers."""
    per_cta = -(-n // c)

    def threads(p):
        return 32 * -(-per_cta // (32 * p))

    for p in REGISTER_TIERS:
        if threads(p) <= MIN_THREADS:
            return Plan(c, threads(p), p)
    fits = [p for p, most in REGISTER_TIERS.items() if threads(p) <= most]
    if not fits:
        return None
    p = min(fits, key=threads)
    return Plan(c, threads(p), p)


def plan(b: int, n: int, sms: int) -> list[Plan]:
    """Launch shapes for b clouds of n points on a card of `sms` SMs, in
    order of preference. The first cluster size fills the card (b * c <=
    sms) up to a portable cluster without cutting a cloud below MIN_SLICE
    points a CTA; each smaller size follows, for the C entry to step down
    to where b clusters of the first do not fit in one wave. A cloud that
    no portable cluster holds in registers takes the non-portable sizes
    that do; one that no cluster holds takes the memory tier."""
    fill = max(1, min(MAX_CLUSTER, sms // b))
    top = max(1, min(MAX_PORTABLE, fill, -(-n // MIN_SLICE)))
    for sizes in (range(top, 0, -1), range(fill, top, -1)):
        regs = [p for c in sizes if (p := register_plan(c, n)) is not None]
        if regs:
            return regs
    return [Plan(c, MAX_THREADS, 0) for c in range(fill, 0, -1)]


def furthest_point_sample(xyz: torch.Tensor, npoint: int,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """xyz [B, N, 3] fp32 CUDA (+mask [B, N]) -> idx [B, npoint] int32."""
    if xyz.dim() == 3 and xyz.shape[0] == 1 and xyz.shape[1] > FLAT_MIN_N:
        return fps_flat(xyz, npoint, mask)
    return fps_batched(xyz, npoint, mask)


def flat_clusters(n: int, device) -> int:
    """The most B2 clusters for a cloud of n points (held to the pruned
    pass's sizes, over FLAT_MIN_N and at most PRUNED_MAX) that the card
    runs at once: cudaOccupancyMaxActiveClusters of plan()'s first shape,
    the query by which the flat entry chooses its plan."""
    device = torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    first = plan(1, min(max(n, FLAT_MIN_N + 1), PRUNED_MAX), sms)[0]
    with torch.cuda.device(device):
        clusters = build.library().tpu3dsad_fps_flat_clusters(
            first.cluster, first.threads)
    if clusters < 1:
        raise RuntimeError(f"tpu3dsad_fps_flat_clusters: no cluster of "
                           f"{first} fits the card")
    return clusters


def deal(codes: torch.Tensor) -> torch.Tensor:
    """Z-order keys codes [N] int32 -> order [ceil(N / SLAB) * SLAB] int32:
    the points' indices in a stable sort of the keys, cut into slabs of
    SLAB, each slab's indices ascending, the last slab padded with N. The
    kernel gives slab s to CTA s mod C, warp s div C, and its element e to
    lane e mod 32 as the thread's point e div 32 (csrc/fps.cu)."""
    n = codes.shape[0]
    perm = torch.sort(codes, stable=True).indices.to(torch.int32)
    order = torch.nn.functional.pad(perm, (0, -n % SLAB), value=n)
    return torch.sort(order.view(-1, SLAB), dim=1).values.view(-1)


def slab_order(xyz: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """The pruned pass's pre-pass for one cloud xyz [1, N, 3] on the card:
    deal() of its Z-order keys (the sorted tier's morton_codes, masked
    points last)."""
    codes, _ = cuda_bq.morton_codes(xyz, xyz[:, :1], mask)
    return deal(codes[0])


def _launch(entry: str, xyz: torch.Tensor, npoint: int,
            mask: torch.Tensor | None, plans: Sequence[Plan] | None,
            engaged: torch.Tensor | None = None) -> tuple[torch.Tensor, Plan]:
    """Launch one C entry on checked arguments; (idx, the plan used). The
    flat entry takes the pruned pass where every candidate holds
    PRUNED_POINTS points a thread; `engaged` needs it."""
    xyz = points_arg(xyz, "xyz")
    valid = mask_arg(mask, xyz)
    B, N, _ = xyz.shape
    if plans is None:
        sms = torch.cuda.get_device_properties(xyz.device).multi_processor_count
        plans = plan(B, N, sms)
    lib = build.library()
    idx = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    # the running distance lives in global memory in the memory tier only
    dist = (torch.empty(B, N, dtype=torch.float32, device=xyz.device)
            if any(p.points == 0 for p in plans) else None)
    flat = (ctypes.c_int * (3 * len(plans)))(*(v for p in plans for v in p))
    used = ctypes.c_int(-1)
    with torch.cuda.device(xyz.device):
        if entry == "tpu3dsad_fps":
            err = lib.tpu3dsad_fps(ptr(xyz), ptr(valid), ptr(dist), ptr(idx),
                                   B, N, npoint, flat, len(plans),
                                   ctypes.byref(used), stream(xyz))
        else:
            order = (slab_order(xyz, mask)
                     if all(p.points == PRUNED_POINTS for p in plans)
                     else None)
            if engaged is not None and order is None:
                raise ValueError("engaged counts the pruned pass, which "
                                 f"takes {PRUNED_POINTS} points a thread")
            err = lib.tpu3dsad_fps_flat(ptr(xyz), ptr(valid), ptr(order),
                                        ptr(dist), ptr(idx), N, npoint, flat,
                                        len(plans), ctypes.byref(used),
                                        ptr(engaged), stream(xyz))
    build.check(err, entry)
    return idx, plans[used.value]


def fps_batched(xyz: torch.Tensor, npoint: int,
                mask: torch.Tensor | None = None,
                plans: Sequence[Plan] | None = None) -> torch.Tensor:
    """B1 at any B and N, one cluster per cloud; `plans` overrides
    plan()'s candidates."""
    global launches, last_plan
    check_fps(xyz, npoint, mask)
    idx, last_plan = _launch("tpu3dsad_fps", xyz, npoint, mask, plans)
    launches += 1
    return idx


def fps_flat(xyz: torch.Tensor, npoint: int,
             mask: torch.Tensor | None = None,
             plans: Sequence[Plan] | None = None,
             engaged: torch.Tensor | None = None) -> torch.Tensor:
    """B2 for one cloud (B == 1) of any N, pruned at PRUNED_POINTS points a
    thread; `plans` overrides plan()'s candidates. `engaged` (a tool's
    counter: one int64 on the card, None on served calls) gets the count of
    warp-rounds that ran their pass added."""
    global flat_launches, flat_points, last_plan, last_cluster
    check_fps(xyz, npoint, mask)
    if xyz.shape[0] != 1:
        raise ValueError(f"fps_flat takes one cloud, got B={xyz.shape[0]}")
    if engaged is not None and (engaged.dtype != torch.int64
                                or engaged.numel() != 1
                                or engaged.device != xyz.device):
        raise ValueError("engaged must be one int64 on xyz's device")
    idx, last_plan = _launch("tpu3dsad_fps_flat", xyz, npoint, mask, plans,
                             engaged)
    flat_launches += 1
    flat_points += xyz.shape[1]
    last_cluster = last_plan.cluster
    return idx
