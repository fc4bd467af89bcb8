"""Masked BatchNorm with call-time momentum (tpu3dsad/nn/norm.py).

Parameters and buffers carry torch's names (weight, bias, running_mean,
running_var) so `utils/bridge.py` maps flax's scale/bias/mean/var onto them
one to one. Fresh modules start as flax's do: scale 1, bias 0, running mean
0, running variance 1.

Two conventions differ from torch.nn.BatchNorm and follow the reference:

  * `momentum` is the weight of the OLD running average (flax), passed at
    call time so the BN-momentum schedule needs no new module: a float, or
    a 0-d tensor on the module's device, which a captured CUDA graph reads
    at each replay (the same fp32 products either way);
  * the variance is the biased one over the valid rows (divided by their
    count, clamped to >= 1), used both to normalise and to update the
    running average.

Padded rows (mask False) contribute to neither statistic but are still
normalised. The running buffers are updated in place by a train-mode call.

`relu=True` applies the ReLU that follows every BatchNorm of the port's
MLPs. In eval mode, where no gradient is recorded (grad mode off, or
none of x, weight and bias needs one), the two are one op,
`tpu3dsad_torch::bn_relu` (ops/library.py): on a CUDA tensor one launch of
csrc/bn_relu.cu, elsewhere the same chain as below, with the same bits
either way. Train mode, and eval mode under autograd, run the chain.

Under data parallelism (parallel.collectives.data_parallel) the train-mode
statistics are the global batch's, as the reference's one SPMD program
computes them: the count and the masked sum are summed over the data
group for the mean, then the centred sum of squares for the variance (two
collectives; their backward sums the gradient over the group, so each
rank's rows get the gradient of every rank's loss). Without a group
nothing is communicated.
"""

from __future__ import annotations

import torch
from torch import nn

from tpu3dsad_torch.ops import library
from tpu3dsad_torch.parallel.collectives import data_group, data_sum


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
                momentum: float | torch.Tensor = 0.9,
                relu: bool = False) -> torch.Tensor:
        """x [..., C]; mask [...] bool (True = real row) -> normalised x,
        through ReLU if `relu`."""
        if relu and not self.training and not self._records_grad(x):
            return library.bn_relu(x, self.running_mean, self.running_var,
                                   self.weight, self.bias, self.eps)
        if self.training:
            rows = x.reshape(-1, x.shape[-1])
            if data_group() is not None:
                mean, var = _global_stats(rows, mask)
            elif mask is None:
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
        y = y * self.weight + self.bias
        return torch.relu(y) if relu else y

    def _records_grad(self, x: torch.Tensor) -> bool:
        return torch.is_grad_enabled() and (
            x.requires_grad or self.weight.requires_grad
            or self.bias.requires_grad)


def _global_stats(rows: torch.Tensor, mask: torch.Tensor | None):
    """(mean, biased variance) over the valid rows of every rank of the
    data group: the count and the sum in one collective, then the centred
    sum of squares."""
    m = (torch.ones_like(rows[:, :1]) if mask is None
         else mask.reshape(-1, 1).to(rows.dtype))
    C = rows.shape[-1]
    sums = data_sum(torch.cat([(rows * m).sum(0), m.sum().reshape(1)]))
    cnt = sums[C].clamp_min(1.0)
    mean = sums[:C] / cnt
    var = data_sum((m * (rows - mean) ** 2).sum(0)) / cnt
    return mean, var
