"""Interpolation weights — plain PyTorch (tpu3dsad/ops/xla/interpolate.py).

three_interpolate itself is in the ops API (ops/__init__.py), where its
gather has the scatter_rows backward.
"""

from __future__ import annotations

import torch


def interp_weights(d2: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights from squared 3-NN distances [B,M,3]."""
    recip = 1.0 / (d2 + eps)
    return recip / recip.sum(-1, keepdim=True)
