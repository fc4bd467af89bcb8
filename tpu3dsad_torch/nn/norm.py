"""Masked BatchNorm with call-time momentum (tpu3dsad/nn/norm.py).

Parameters and buffers carry torch's names (weight, bias, running_mean,
running_var) so `utils/bridge.py` maps flax's scale/bias/mean/var onto them
one to one. Fresh modules start as flax's do: scale 1, bias 0, running mean
0, running variance 1.

Two conventions differ from torch.nn.BatchNorm and follow the reference:

  * `momentum` is the weight of the OLD running average (flax), passed at
    call time so the BN-momentum schedule needs no new module;
  * the variance is the biased one over the valid rows (divided by their
    count, clamped to >= 1), used both to normalise and to update the
    running average.

Padded rows (mask False) contribute to neither statistic but are still
normalised. The running buffers are updated in place by a train-mode call.
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over all axes but the last, mask-aware."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, *, mask: torch.Tensor | None = None,
                momentum: float = 0.9) -> torch.Tensor:
        """x [..., C]; mask [...] bool (True = real row) -> normalised x."""
        if self.training:
            rows = x.reshape(-1, x.shape[-1])
            if mask is None:
                mean = rows.mean(0)
                var = rows.var(0, unbiased=False)
            else:
                m = mask.reshape(-1, 1).to(x.dtype)
                cnt = m.sum().clamp_min(1.0)
                mean = (rows * m).sum(0) / cnt
                var = (m * (rows - mean) ** 2).sum(0) / cnt
            with torch.no_grad():
                self.running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
                self.running_var.mul_(momentum).add_((1.0 - momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias
