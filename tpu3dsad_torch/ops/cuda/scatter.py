"""Wrapper of the row scatter-add kernel (csrc/scatter.cu), which replaces
the Pallas TPU kernels tpu3dsad/ops/pallas/scatter.py::_kernel_c_lanes and
::_kernel_n_lanes. It is the backward of gather/group (ops.gather).

The kernel sums each row in u order, so its result is the same in every
run and bitwise numpy's np.add.at in float32. One launch, no scratch, no
atomic: each CTA keeps the entries of its rows (dealt round robin) in
shared memory, gathers their rows of g there with cp.async, and each warp
sums its rows from there (csrc/scatter.cu).

`plan` chooses the launch shape, a pure function of (B, U, n, C, SM count)
that the CPU tests pin. `launches` counts the kernel's launches by this
wrapper, so a run can show that its main path went through the kernel;
`last_plan` is the plan of the last one.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch

from tpu3dsad_torch.ops.args import check_scatter
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda.common import ptr, stream

ROWS = 2  # rows a warp sums (the kernel's kRows)
MAX_WARPS = 32
MAX_BLOCKS = 9  # 32-channel blocks a warp holds: a slice of <= 288
MAX_U = 1 << 24  # entries a cloud (the kernel packs u in 24 bits)
WARPS = 16  # a CTA (measured: PERF.md)


class Plan(NamedTuple):
    """One launch shape: CTAs of `warps` warps, each owning at most
    ROWS x warps rows of a cloud (dealt round robin), the channels cut
    into `slices` slices of ceil(C / slices) (at most 32 x MAX_BLOCKS)."""
    warps: int
    slices: int

    def __str__(self) -> str:
        return f"{self.warps} warps, {self.slices} slices"


launches = 0
last_plan: Plan | None = None


def blocks(c: int, slices: int) -> int:
    """32-channel blocks a warp holds for c channels in `slices` slices."""
    return -(-(-(-c // slices)) // 32)

@functools.lru_cache(maxsize=256)
def plan(b: int, u: int, n: int, c: int, sms: int) -> Plan:
    """The launch shape for b clouds of u entries into n rows of c
    channels on a card of `sms` SMs: CTAs of WARPS warps, the channels in
    as few slices as a warp holds. Measured (PERF.md, `profile_port.py
    --scatter`): 16 warps were the fastest or within the noise at every
    call of a config-#3 step, and more slices did not pay for reading idx
    once more a slice."""
    del b, u, n, sms
    return Plan(WARPS, -(-c // (32 * MAX_BLOCKS)))


_sms: dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _sms:
        _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sms[dev.index]


def scatter_rows(g: torch.Tensor, idx: torch.Tensor, n: int,
                 launch: Plan | None = None) -> torch.Tensor:
    """g [B,U,C] fp32 CUDA, idx [B,U] int -> out [B,n,C] fp32. g is read
    through its strides where its channels are contiguous (no copy);
    `launch` overrides plan()."""
    global launches, last_plan
    check_scatter(g, idx, n)
    if g.device.type != "cuda":
        raise ValueError(f"g must be a CUDA tensor, got {g.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"g must be float32, got {g.dtype}")
    if idx.device != g.device:
        raise ValueError(f"idx must be on {g.device}, got {idx.device}")
    B, U, C = g.shape
    if U >= MAX_U:
        raise ValueError(f"at most {MAX_U - 1} entries a cloud, got {U}")
    if g.stride(2) != 1:
        g = g.contiguous()
    idx = idx.to(torch.int32).contiguous()
    dev = g.device
    if launch is None:
        launch = plan(B, U, n, C, _sm_count(dev))
    lib = build.library()
    out = torch.empty(B, n, C, dtype=torch.float32, device=dev)
    here = (contextlib.nullcontext()
            if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))
    with here:
        err = lib.tpu3dsad_scatter_rows(
            ptr(g), g.stride(0), g.stride(1), ptr(idx), ptr(out), B, U, C, n,
            launch.warps, launch.slices, stream(g))
    build.check(err, "tpu3dsad_scatter_rows")
    launches += 1
    last_plan = launch
    return out
