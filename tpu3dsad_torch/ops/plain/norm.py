"""Eval-mode BatchNorm + ReLU as plain PyTorch: the chain that
nn/norm.py's MaskedBatchNorm runs, op for op, so the kernel
(csrc/bn_relu.cu) is held to its bits."""

from __future__ import annotations

import torch

from tpu3dsad_torch.ops.args import check_bn_relu


def bn_relu(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
            weight: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """x [..., C]; mean, var, weight, bias [C] ->
    relu(((x - mean) * rsqrt(var + eps)) * weight + bias)."""
    check_bn_relu(x, mean, var, weight, bias)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * weight + bias
    return torch.relu(y)
