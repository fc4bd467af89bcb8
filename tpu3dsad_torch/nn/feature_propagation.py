"""Feature propagation (tpu3dsad/nn/feature_propagation.py).

Inverse-distance-weighted 3-NN interpolation of coarse features onto the
dense set, concat with the skip features, shared MLP.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from tpu3dsad_torch import ops
from tpu3dsad_torch.nn.mlp import SharedMLP


class FeaturePropagation(nn.Module):
    """in_channels: skip-feature channels + interpolated-feature channels."""

    def __init__(self, in_channels: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp)

    def forward(self, dense_xyz, dense_features, sparse_xyz, sparse_features,
                *, sparse_mask=None):
        """Interpolate sparse [B,S,C] features onto dense [B,N,3] points ->
        [B, N, mlp[-1]]."""
        d2, idx = ops.three_nn(dense_xyz, sparse_xyz, support_mask=sparse_mask)
        # all-invalid support leaves +inf distances; keep the weights finite
        d2 = torch.where(torch.isfinite(d2), d2, 1e10)
        interp = ops.three_interpolate(sparse_features, idx,
                                       ops.interp_weights(d2))
        if dense_features is not None:
            interp = torch.cat([dense_features, interp], -1)
        return self.mlp(interp)
