"""Masked reductions — the padding discipline of the shape-static model.

Counterpart of tpu3dsad/ops/masked.py: padded slots never win a max-pool
(sentinel -1e30) and an all-invalid group pools to 0, not -inf, so empty
proposal groups stay finite.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # finite sentinel, as in the reference


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Max over `dim` counting only mask=True slots; all-invalid -> 0."""
    mask = mask.bool()
    if mask.dim() == x.dim() - 1:
        mask = mask.unsqueeze(-1)
    out = torch.where(mask, x, NEG_INF).amax(dim)
    return torch.where(mask.any(dim), out, 0.0)
