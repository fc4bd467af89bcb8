"""Shared MLP blocks and the classifier's FC head (tpu3dsad/nn/mlp.py),
and flax-like initialisation.

The lineage's 1x1 convs over channels-first tensors are, channels-last,
plain Linear layers applied over the last axis. Module names follow the
flax tree (dense_{i}, bn_{i}; fc_{i}, bn_{i}, out) so weights bridge by
name.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
from torch import nn

from tpu3dsad_torch.nn.norm import MaskedBatchNorm
from tpu3dsad_torch.parallel.collectives import batch_rows

# stddev of a standard normal truncated to [-2, 2]; flax's lecun_normal
# divides by it so the truncated draw keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def init_like_flax_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every Linear as a fresh flax Dense: lecun-normal kernel
    (truncated normal, variance 1/fan_in) and zero bias. Norm layers
    already start at flax's values. Draws in module-registration order."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


class SharedMLP(nn.Module):
    """Linear + BN + ReLU stack over the last axis of any [..., C] tensor.

    Linear layers have no bias because BN follows (tpu3dsad/nn/mlp.py:36),
    unless `bias` asks for one (3DSSD's convs that have it); `eps` is
    BatchNorm's. The reference's use_bn=False / activate_final=False
    variants have no caller on the inference path and are not ported."""

    def __init__(self, in_channels: int, channels: Sequence[int], *,
                 eps: float = 1e-5, bias: bool = False):
        super().__init__()
        self.n = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"dense_{i}", nn.Linear(in_channels, ch,
                                                    bias=bias))
            self.add_module(f"bn_{i}", MaskedBatchNorm(ch, eps))
            in_channels = ch

    def forward(self, x: torch.Tensor, *, mask: torch.Tensor | None = None,
                bn_momentum: float | torch.Tensor = 0.9) -> torch.Tensor:
        """x [..., C]; mask [...] gates the BN statistics in training."""
        for i in range(self.n):
            x = getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(x),
                                         mask=mask, momentum=bn_momentum,
                                         relu=True)
        return x


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax's nn.Dropout in training: keep each entry with probability
    1 - p, drawn from `generator` (never torch's global RNG), and scale
    the kept ones by 1 / (1 - p); p = 0 returns x, p = 1 zeros. Under
    data parallelism x [B, ...] holds this rank's rows, and the draw is
    made for the global batch and cut to them (collectives.batch_rows)."""
    if p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep_prob = 1.0 - p
    rows, mine = batch_rows(x.shape[0])
    draw = torch.rand((rows, *x.shape[1:]), generator=generator,
                      device=x.device)[mine]
    keep = draw < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


class MLPHead(nn.Module):
    """FC head: (Linear without bias, BN over [B, C] rows, ReLU, dropout)
    per width, then the `out` Linear with bias (the classifier tail,
    tpu3dsad/nn/mlp.py:46-63). Dropout runs in training mode only, on
    the generator the caller passes."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 num_out: int, dropout: float = 0.5):
        super().__init__()
        self.n = len(channels)
        self.p = dropout
        for i, ch in enumerate(channels):
            self.add_module(f"fc_{i}", nn.Linear(in_channels, ch, bias=False))
            self.add_module(f"bn_{i}", MaskedBatchNorm(ch))
            in_channels = ch
        self.out = nn.Linear(in_channels, num_out)

    def forward(self, x: torch.Tensor, *,
                bn_momentum: float | torch.Tensor = 0.9,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x [B, C] -> [B, num_out]."""
        for i in range(self.n):
            x = getattr(self, f"bn_{i}")(getattr(self, f"fc_{i}")(x),
                                         momentum=bn_momentum, relu=True)
            if self.training:
                x = dropout(x, self.p, generator)
        return self.out(x)
