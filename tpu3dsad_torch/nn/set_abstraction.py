"""Set abstraction, SSG and MSG (tpu3dsad/nn/set_abstraction.py:63-108).

Sample (FPS) -> group (ball query at one or more radii) -> shared MLP ->
masked max-pool per group. Pad slots and groups around invalid centers
never win the pool. GroupAll and the context-parallel branch are not
ported yet (ROADMAP A8 and A11).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from tpu3dsad_torch import ops
from tpu3dsad_torch.nn.mlp import SharedMLP


class SetAbstraction(nn.Module):
    """in_features: channels of the per-point features (0 for none)."""

    def __init__(self, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 in_features: int = 0, use_xyz: bool = True,
                 normalize_xyz: bool = False):
        super().__init__()
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.use_xyz = use_xyz
        self.normalize_xyz = normalize_xyz
        # as ops.query_and_group builds it: xyz only, xyz + features, or
        # features only
        in_ch = 3 if in_features == 0 else in_features + 3 * use_xyz
        for s, channels in enumerate(mlps):
            self.add_module(f"mlp_{s}", SharedMLP(in_ch, channels))
        self.out_channels = sum(c[-1] for c in mlps)

    def forward(self, xyz, features=None, *, mask=None, inds=None,
                bn_momentum=0.9):
        """xyz [B,N,3], features [B,N,C] -> (new_xyz [B,M,3],
        new_features [B,M,C'], inds [B,M], new_mask [B,M])."""
        if inds is None:
            inds = ops.furthest_point_sample(xyz, self.npoint, mask=mask)
        new_xyz = ops.gather(xyz, inds)
        new_mask = (torch.ones(inds.shape, dtype=torch.bool, device=xyz.device)
                    if mask is None else mask.bool().gather(1, inds.long()))
        pooled = []
        for s, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            grouped, _, gmask = ops.query_and_group(
                xyz, new_xyz, radius, nsample, features=features, mask=mask,
                use_xyz=self.use_xyz, normalize_xyz=self.normalize_xyz,
            )
            gmask = gmask & new_mask[:, :, None]
            h = getattr(self, f"mlp_{s}")(grouped, mask=gmask,
                                          bn_momentum=bn_momentum)
            pooled.append(ops.masked_max(h, gmask, 2))
        new_features = torch.cat(pooled, -1) if len(pooled) > 1 else pooled[0]
        return new_xyz, new_features, inds, new_mask
