"""Voting module (tpu3dsad/models/voting.py): each seed regresses a vote,
an xyz offset and a feature delta."""

from __future__ import annotations

import torch
from torch import nn

from tpu3dsad_torch.nn.norm import MaskedBatchNorm


class VotingModule(nn.Module):
    """in_dim: seed feature channels C; votes carry C channels too."""

    def __init__(self, in_dim: int, vote_factor: int = 1, feat_dim: int = 256):
        super().__init__()
        self.vote_factor = vote_factor
        # the lineage's Conv1d keeps its bias even before BN (voting.py:32)
        self.dense_0 = nn.Linear(in_dim, feat_dim)
        self.bn_0 = MaskedBatchNorm(feat_dim)
        self.dense_1 = nn.Linear(feat_dim, feat_dim)
        self.bn_1 = MaskedBatchNorm(feat_dim)
        self.out = nn.Linear(feat_dim, vote_factor * (3 + in_dim))

    def forward(self, seed_xyz, seed_features, *, mask=None, bn_momentum=0.9):
        """seed_xyz [B,S,3], seed_features [B,S,C] ->
        (vote_xyz [B,S*F,3], vote_features [B,S*F,C], vote_mask [B,S*F])."""
        B, S, C = seed_features.shape
        F = self.vote_factor
        bn = dict(mask=mask, momentum=bn_momentum, relu=True)
        x = self.bn_0(self.dense_0(seed_features), **bn)
        x = self.bn_1(self.dense_1(x), **bn)
        out = self.out(x).reshape(B, S, F, 3 + C)
        vote_xyz = seed_xyz[:, :, None, :] + out[..., :3]
        vote_feat = seed_features[:, :, None, :] + out[..., 3:]
        vote_mask = (torch.ones(B, S, dtype=torch.bool, device=seed_xyz.device)
                     if mask is None else mask.bool())
        vote_mask = vote_mask[:, :, None].expand(B, S, F)
        return (vote_xyz.reshape(B, S * F, 3), vote_feat.reshape(B, S * F, C),
                vote_mask.reshape(B, S * F))
