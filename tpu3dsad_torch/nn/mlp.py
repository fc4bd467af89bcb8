"""Shared MLP blocks (tpu3dsad/nn/mlp.py) and flax-like initialisation.

The lineage's 1x1 convs over channels-first tensors are, channels-last,
plain Linear layers applied over the last axis. Module names follow the
flax tree (dense_{i}, bn_{i}) so weights bridge by name.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
from torch import nn

from tpu3dsad_torch.nn.norm import MaskedBatchNorm

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

    Linear layers have no bias because BN follows (tpu3dsad/nn/mlp.py:36).
    The reference's use_bn=False / activate_final=False variants have no
    caller on the inference path and are not ported."""

    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        self.n = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"dense_{i}", nn.Linear(in_channels, ch,
                                                    bias=False))
            self.add_module(f"bn_{i}", MaskedBatchNorm(ch))
            in_channels = ch

    def forward(self, x: torch.Tensor, *, mask: torch.Tensor | None = None,
                bn_momentum: float = 0.9) -> torch.Tensor:
        """x [..., C]; mask [...] gates the BN statistics in training."""
        for i in range(self.n):
            x = getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(x),
                                         mask=mask, momentum=bn_momentum)
            x = torch.relu(x)
        return x
