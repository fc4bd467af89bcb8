"""Wrapper of the row scatter-add kernel (csrc/scatter.cu), which replaces
the Pallas TPU kernels tpu3dsad/ops/pallas/scatter.py::_kernel_c_lanes and
::_kernel_n_lanes. It is the backward of gather/group (ops.gather).

`launches` counts kernel launches made by this wrapper, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import torch

from tpu3dsad_torch.ops.args import check_scatter
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda.common import points_arg, ptr, stream

launches = 0


def scatter_rows(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """g [B,U,C] fp32 CUDA, idx [B,U] int -> out [B,n,C] fp32."""
    global launches
    check_scatter(g, idx, n)
    g = points_arg(g, "g")
    if idx.device != g.device:
        raise ValueError(f"idx must be on {g.device}, got {idx.device}")
    idx = idx.to(torch.int32).contiguous()
    B, U, C = g.shape
    lib = build.library()
    out = torch.zeros(B, n, C, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.tpu3dsad_scatter_rows(ptr(g), ptr(idx), ptr(out), B, U, C,
                                        n, stream(g))
    build.check(err, "tpu3dsad_scatter_rows")
    launches += 1
    return out
