"""Wrapper of the feature-space FPS kernel (3DSSD's F-FPS) of
csrc/ffps.cu, entry tpu3dsad_ffps: one thread-block cluster per cloud of
B clouds of N points of D values each.

The kernel reads each point's values as float4s, so the wrapper pads them
with zeros to 4 * dp4 floats, dp4 = ceil(D / 4) made odd (a zero pad
leaves the distance bit for bit; an odd stride keeps 128-bit shared loads
free of bank conflicts).

`plan` chooses the launch shapes, a pure function of (B, N, D, SM count)
that the CPU tests pin, in order of preference: the CTAs a cloud that
fill the card (B * C <= SMs, at most a portable cluster of 8) without
cutting a slice below MIN_SLICE points, then each smaller cluster whose
slices still fit one CTA's shared memory, then the larger ones up to 8
that hold them, each with the fewest threads (a multiple of 32, at most
512) that hold a slice at 1, 2, 4, 8 or 16 points a thread (`plan_at`);
the C entry launches the first whose B clusters the card places in one
wave. A cloud whose slices fit no cluster of 8 CTAs' shared memory (past
~6800 points of 3DSSD's 67 values) is refused.

`launches` counts the launches and `work` sums their points x dims x
rounds (B * N * D * (npoint - 1), D before the padding), for the
roofline reader; `last_plan` is the plan of the last launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from tpu3dsad_torch.ops.args import check_ffps
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda.common import mask_arg, points_arg, ptr, stream

MAX_THREADS = 512
MAX_CLUSTER = 8  # portable clusters only
MIN_SLICE = 128
POINTS_A_THREAD = (1, 2, 4, 8, 16)
# dynamic shared memory a CTA may hold for its slice and the pick vector
# (227 KB on Hopper, less the static exchange slots)
SLICE_BYTES = 225 * 1024
F4 = 16  # bytes of a float4


class Plan(NamedTuple):
    """One launch shape: `cluster` CTAs of `threads` threads per cloud,
    `points` points a thread."""
    cluster: int
    threads: int
    points: int


launches = 0
work = 0
last_plan: Plan | None = None


def row_float4s(d: int) -> int:
    """dp4: the float4s of a padded row of d values (odd)."""
    q = -(-d // 4)
    return q + 1 - q % 2


def plan_at(n: int, d: int, c: int) -> Plan | None:
    """The shape of clusters of c CTAs for clouds of n points of d values:
    the fewest threads at the fewest points a thread; None where a slice
    and the pick vector do not fit a CTA's shared memory or no shape holds
    the slice."""
    slice_ = -(-n // c)
    if (slice_ + 1) * row_float4s(d) * F4 > SLICE_BYTES:
        return None
    for p in POINTS_A_THREAD:
        threads = 32 * -(-slice_ // (32 * p))
        if threads <= MAX_THREADS:
            return Plan(c, threads, p)
    return None


def plan(b: int, n: int, d: int, sms: int) -> list[Plan]:
    """Launch shapes for b clouds of n points of d values on a card of
    `sms` SMs, in order of preference (module docstring); raises where no
    shape holds a cloud."""
    fill = max(1, min(MAX_CLUSTER, sms // b))
    top = min(n, max(1, min(fill, -(-n // MIN_SLICE))))
    for sizes in (range(top, 0, -1), range(top + 1, min(MAX_CLUSTER, n) + 1)):
        plans = [p for c in sizes if (p := plan_at(n, d, c))]
        if plans:
            return plans
    raise ValueError(f"feature FPS holds a cloud in the shared memory of at "
                     f"most {MAX_CLUSTER} CTAs: {n} points of {d} values do "
                     f"not fit")


def feature_fps(points: torch.Tensor, npoint: int,
                mask: torch.Tensor | None = None,
                plans: Sequence[Plan] | None = None) -> torch.Tensor:
    """points [B, N, D] fp32 CUDA (+mask [B, N]) -> idx [B, npoint] int32;
    `plans` overrides plan()'s candidates."""
    global launches, work, last_plan
    check_ffps(points, npoint, mask)
    points = points_arg(points, "points")
    valid = mask_arg(mask, points)
    B, N, D = points.shape
    dp4 = row_float4s(D)
    if plans is None:
        sms = torch.cuda.get_device_properties(
            points.device).multi_processor_count
        plans = plan(B, N, D, sms)
    rows = torch.nn.functional.pad(points, (0, 4 * dp4 - D)).contiguous()
    idx = torch.empty(B, npoint, dtype=torch.int32, device=points.device)
    flat = (ctypes.c_int * (3 * len(plans)))(
        *(int(v) for p in plans for v in p))
    used = ctypes.c_int(-1)
    lib = build.library()
    with torch.cuda.device(points.device):
        err = lib.tpu3dsad_ffps(ptr(rows), ptr(valid), ptr(idx), B, N, dp4,
                                npoint, flat, len(plans), ctypes.byref(used),
                                stream(points))
    build.check(err, "tpu3dsad_ffps")
    launches += 1
    work += B * N * D * (npoint - 1)
    last_plan = plans[used.value]
    return idx
