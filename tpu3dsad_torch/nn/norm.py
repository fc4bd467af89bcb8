"""Masked BatchNorm (tpu3dsad/nn/norm.py), inference form.

Parameters and buffers carry torch's names (weight, bias, running_mean,
running_var) so `utils/bridge.py` maps flax's scale/bias/mean/var onto them
one to one. Fresh modules start as flax's do: scale 1, bias 0, running mean
0, running variance 1.

Only eval mode is ported: masked batch statistics and the call-time
momentum belong to the training slice (ROADMAP A7).
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over all axes but the last; eval mode."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., C] -> (x - mean) * rsqrt(var + eps) * scale + bias."""
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm train mode (masked statistics) is not "
                "ported yet (ROADMAP A7); call model.eval()")
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias
