"""Wrapper of the eval-mode BatchNorm + ReLU kernel (csrc/bn_relu.cu),
which replaces the plain chain (ops/plain/norm.py: x - mean, * rsqrt(var +
eps), * weight, + bias, then ReLU; seven launches and five passes over the
activation) with one launch that reads the activation once and writes the
result once, with the chain's bits.

`launches` counts the kernel's launches by this wrapper, one a BatchNorm
layer of an eval-mode forward, so a run can show that its layers went
through the kernel.
"""

from __future__ import annotations

import contextlib

import torch

from tpu3dsad_torch.ops.args import check_bn_relu
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda.common import points_arg, ptr, stream

launches = 0


def bn_relu(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
            weight: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """x [..., C] fp32 CUDA; mean, var, weight, bias [C] fp32 on its
    device -> relu(((x - mean) * rsqrt(var + eps)) * weight + bias), a new
    tensor bitwise the plain chain's (eps rounded to fp32, as torch rounds
    it)."""
    global launches
    check_bn_relu(x, mean, var, weight, bias)
    x = points_arg(x, "x")
    dev = x.device
    vecs = []
    for name, v in (("mean", mean), ("var", var), ("weight", weight),
                    ("bias", bias)):
        if v.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {v.device}")
        vecs.append(points_arg(v, name))
    C = x.shape[-1]
    rows = x.numel() // C if C else 0
    lib = build.library()
    out = torch.empty_like(x)
    here = (contextlib.nullcontext()
            if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))
    with here:
        err = lib.tpu3dsad_bn_relu(ptr(x), *map(ptr, vecs), eps, ptr(out),
                                   rows, C, stream(x))
    build.check(err, "tpu3dsad_bn_relu")
    launches += 1
    return out
