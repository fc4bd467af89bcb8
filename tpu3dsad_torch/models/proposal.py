"""Size-adaptive clustering + proposal head (tpu3dsad/models/proposal.py,
SizeAdaptiveProposal with sampling='fps', :115-228).

Votes are grouped at a static bank of radii; each radius runs its own
shared MLP + masked max-pool; a scale-selection head gives logits over the
bank. The proposal feature blends the bank entries: by the softmax of the
logits in training (differentiable), by the one-hot of their argmax in
eval.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from tpu3dsad_torch import ops
from tpu3dsad_torch.nn.mlp import SharedMLP
from tpu3dsad_torch.nn.norm import MaskedBatchNorm


def density_biased_fps(*args, **kwargs):
    raise NotImplementedError(
        "density_biased_fps (proposal_sampling='density') is not ported yet "
        "(ROADMAP A5b)")


class LineageProposal(nn.Module):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "LineageProposal (proposal_mode='lineage') is not ported yet "
            "(ROADMAP A5b)")


class SizeAdaptiveProposal(nn.Module):
    """in_dim: vote feature channels."""

    def __init__(self, num_classes: int, in_dim: int,
                 num_heading_bins: int = 12, num_proposals: int = 256,
                 radius_bank: Sequence[float] = (0.15, 0.3, 0.6),
                 nsample: int = 16, feat_dim: int = 128,
                 sampling: str = "fps"):
        super().__init__()
        if sampling == "density":
            density_biased_fps()
        if sampling != "fps":
            raise ValueError(
                f"model.proposal_sampling={sampling!r}: expected 'fps' or "
                "'density'")
        self.num_proposals = num_proposals
        self.radius_bank = tuple(radius_bank)
        self.nsample = nsample
        R = len(self.radius_bank)
        for r_i in range(R):
            self.add_module(f"scale_mlp_{r_i}",
                            SharedMLP(3 + in_dim, (feat_dim,) * 3))
        self.scale_sel_mlp = SharedMLP(R * feat_dim, (feat_dim,))
        self.scale_sel_out = nn.Linear(feat_dim, R)
        # the lineage's Conv1d keeps its bias even before BN (proposal.py:214)
        self.head_0 = nn.Linear(feat_dim, feat_dim)
        self.head_bn_0 = MaskedBatchNorm(feat_dim)
        self.head_1 = nn.Linear(feat_dim, feat_dim)
        self.head_bn_1 = MaskedBatchNorm(feat_dim)
        out_ch = 2 + 3 + num_heading_bins * 2 + num_classes * 4 + num_classes
        self.head_out = nn.Linear(feat_dim, out_ch)

    def forward(self, vote_xyz, vote_features, *, vote_mask=None,
                bn_momentum=0.9):
        """Returns dict with raw proposal params + scale logits."""
        inds = ops.furthest_point_sample(vote_xyz, self.num_proposals,
                                         mask=vote_mask)
        center_mask = (
            torch.ones(inds.shape, dtype=torch.bool, device=vote_xyz.device)
            if vote_mask is None else vote_mask.bool().gather(1, inds.long()))
        centers = ops.gather(vote_xyz, inds)  # [B, P, 3]

        scale_feats = []
        for r_i, radius in enumerate(self.radius_bank):
            grouped, _, gmask = ops.query_and_group(
                vote_xyz, centers, radius, self.nsample,
                features=vote_features, mask=vote_mask, use_xyz=True,
                normalize_xyz=True,
            )
            gmask = gmask & center_mask[:, :, None]
            h = getattr(self, f"scale_mlp_{r_i}")(grouped, mask=gmask,
                                                  bn_momentum=bn_momentum)
            scale_feats.append(ops.masked_max(h, gmask, 2))  # [B,P,D]
        stacked = torch.stack(scale_feats, 2)  # [B, P, R, D]

        B, P, R, D = stacked.shape
        sel_h = self.scale_sel_mlp(stacked.reshape(B, P, R * D),
                                   mask=center_mask, bn_momentum=bn_momentum)
        scale_logits = self.scale_sel_out(sel_h)  # [B, P, R]
        if self.training:
            blend = torch.softmax(scale_logits, -1)
        else:
            blend = nn.functional.one_hot(scale_logits.argmax(-1), R).to(
                stacked.dtype)
        feat = torch.einsum("bprd,bpr->bpd", stacked, blend)

        bn = dict(mask=center_mask, momentum=bn_momentum)
        x = torch.relu(self.head_bn_0(self.head_0(feat), **bn))
        x = torch.relu(self.head_bn_1(self.head_1(x), **bn))
        return {
            "proposal_xyz": centers,
            "proposal_inds": inds,
            "proposal_mask": center_mask,
            "scale_logits": scale_logits,
            "raw_params": self.head_out(x),
        }
