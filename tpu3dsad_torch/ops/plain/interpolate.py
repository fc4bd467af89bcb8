"""Three-interpolate — plain PyTorch (tpu3dsad/ops/xla/interpolate.py)."""

from __future__ import annotations

import torch

from tpu3dsad_torch.ops.plain.group import group


def interp_weights(d2: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights from squared 3-NN distances [B,M,3]."""
    recip = 1.0 / (d2 + eps)
    return recip / recip.sum(-1, keepdim=True)


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """feats [B,N,C], idx [B,M,3], weight [B,M,3] -> [B,M,C]."""
    return torch.einsum("bmkc,bmk->bmc", group(feats, idx), weight)
