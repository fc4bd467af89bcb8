"""Size-adaptive clustering + proposal heads (tpu3dsad/models/proposal.py).

SizeAdaptiveProposal groups the votes at a static bank of radii; each
radius runs its own shared MLP + masked max-pool; a scale-selection head
gives logits over the bank. The proposal feature blends the bank entries:
by the softmax of the logits in training (differentiable), by the one-hot
of their argmax in eval. Its centers come from FPS over the votes
(sampling='fps') or from FPS over the votes of highest local density
(sampling='density', density_biased_fps).

LineageProposal is the lineage VoteNet head (model.proposal_mode=
'lineage'): FPS over the votes, one fixed-radius grouping, a shared MLP
and max-pool; it gives no scale logits.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch
from torch import nn

from tpu3dsad_torch import ops
from tpu3dsad_torch.nn.mlp import SharedMLP
from tpu3dsad_torch.nn.norm import MaskedBatchNorm


def _vote_density(x, valid, r2):
    """density[b,v] = #valid votes with d2 < r2 of vote v (strict, as in
    the exact ball query; a valid vote counts itself).

    d2 is elementwise (dx*dx + dy*dy) + dz*dz in fp32, never the
    |a|^2 + |b|^2 - 2a.b expansion, whose cancellation flips membership at
    the boundary. Row slabs keep the live [B, slab, V, 3] difference near
    2^21 elements a batch row, as the reference's scan does."""
    B, V, _ = x.shape
    slab = min(V, max(64, (1 << 21) // V))
    out = []
    for s in range(0, V, slab):
        d = x[:, s:s + slab, None, :] - x[:, None, :, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        out.append(((d2 < r2) & valid[:, None, :]).sum(-1, dtype=torch.int32))
    return torch.cat(out, 1)


def density_biased_fps(vote_xyz, num_proposals: int, radius: float,
                       vote_mask=None, candidate_factor: int = 4):
    """Foreground-biased proposal centers: in sparse outdoor clouds most
    votes stay on the background, while votes from object surfaces
    converge near the object centers. So: the density of each vote
    (_vote_density at `radius`), the C = num_proposals x candidate_factor
    densest votes (ties to the lower index, pads last), then FPS (B1)
    among those C.

    Returns (inds [B,P] into the vote set, center_mask [B,P]). The
    selection is integer work outside the autograd graph: its gather
    needs no backward."""
    B, V, _ = vote_xyz.shape
    C = min(V, num_proposals * candidate_factor)
    with torch.no_grad():
        valid = (torch.ones(B, V, dtype=torch.bool, device=vote_xyz.device)
                 if vote_mask is None else vote_mask.bool())
        x = vote_xyz.detach().float()
        density = _vote_density(x, valid, float(np.float32(radius) ** 2))
        density = torch.where(valid, density, -1)  # pads never rank
        # a stable sort of -density: density descending, index ascending
        cand = torch.argsort(-density, dim=1, stable=True)[:, :C]
        cand_xyz = ops.gather(x, cand)
        sub = ops.furthest_point_sample(cand_xyz, num_proposals,
                                        mask=valid.gather(1, cand))
        inds = cand.gather(1, sub.long()).to(sub.dtype)
        return inds, valid.gather(1, inds.long())


def _sample_proposal_centers(vote_xyz, num_proposals, vote_mask, *,
                             sampling: str, density_radius: float,
                             candidate_factor: int):
    """(inds [B,P], center_mask [B,P]) of the adaptive head's sampling."""
    if sampling == "density":
        return density_biased_fps(vote_xyz, num_proposals, density_radius,
                                  vote_mask=vote_mask,
                                  candidate_factor=candidate_factor)
    if sampling != "fps":
        raise ValueError(
            f"model.proposal_sampling={sampling!r}: expected 'fps' or "
            "'density'")
    return _fps_centers(vote_xyz, num_proposals, vote_mask)


def _fps_centers(vote_xyz, num_proposals, vote_mask):
    """(inds, center_mask) of FPS over the votes, the lineage's sampling."""
    inds = ops.furthest_point_sample(vote_xyz, num_proposals, mask=vote_mask)
    center_mask = (
        torch.ones(inds.shape, dtype=torch.bool, device=vote_xyz.device)
        if vote_mask is None else vote_mask.bool().gather(1, inds.long()))
    return inds, center_mask


def _add_box_head(module: nn.Module, in_dim: int, feat_dim: int,
                  out_ch: int) -> None:
    """Register the lineage's Conv1d head in_dim -> feat_dim -> feat_dim ->
    out_ch on `module` under the flax names (head_0, head_bn_0, ...,
    head_out); the Conv1d keeps its bias even before BN (proposal.py:214)."""
    for i in range(2):
        module.add_module(f"head_{i}", nn.Linear(in_dim if i == 0
                                                 else feat_dim, feat_dim))
        module.add_module(f"head_bn_{i}", MaskedBatchNorm(feat_dim))
    module.head_out = nn.Linear(feat_dim, out_ch)


def _box_head(module: nn.Module, x, center_mask, bn_momentum):
    """The head of _add_box_head on the proposal features -> raw params."""
    for i in range(2):
        x = getattr(module, f"head_{i}")(x)
        x = getattr(module, f"head_bn_{i}")(
            x, mask=center_mask, momentum=bn_momentum, relu=True)
    return module.head_out(x)


def _out_channels(num_heading_bins: int, num_classes: int) -> int:
    return 2 + 3 + num_heading_bins * 2 + num_classes * 4 + num_classes


class SizeAdaptiveProposal(nn.Module):
    """in_dim: vote feature channels. sampling: 'fps' or 'density'
    (_sample_proposal_centers, with density_radius and
    candidate_factor)."""

    def __init__(self, num_classes: int, in_dim: int,
                 num_heading_bins: int = 12, num_proposals: int = 256,
                 radius_bank: Sequence[float] = (0.15, 0.3, 0.6),
                 nsample: int = 16, feat_dim: int = 128,
                 sampling: str = "fps", density_radius: float = 0.3,
                 candidate_factor: int = 4):
        super().__init__()
        self.num_proposals = num_proposals
        self.radius_bank = tuple(radius_bank)
        self.nsample = nsample
        self.sampling = sampling
        self.density_radius = density_radius
        self.candidate_factor = candidate_factor
        R = len(self.radius_bank)
        for r_i in range(R):
            self.add_module(f"scale_mlp_{r_i}",
                            SharedMLP(3 + in_dim, (feat_dim,) * 3))
        self.scale_sel_mlp = SharedMLP(R * feat_dim, (feat_dim,))
        self.scale_sel_out = nn.Linear(feat_dim, R)
        _add_box_head(self, feat_dim, feat_dim,
                      _out_channels(num_heading_bins, num_classes))

    def forward(self, vote_xyz, vote_features, *, vote_mask=None,
                bn_momentum=0.9):
        """Returns dict with raw proposal params + scale logits."""
        inds, center_mask = _sample_proposal_centers(
            vote_xyz, self.num_proposals, vote_mask, sampling=self.sampling,
            density_radius=self.density_radius,
            candidate_factor=self.candidate_factor)
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
        return {
            "proposal_xyz": centers,
            "proposal_inds": inds,
            "proposal_mask": center_mask,
            "scale_logits": scale_logits,
            "raw_params": _box_head(self, feat, center_mask, bn_momentum),
        }


class LineageProposal(nn.Module):
    """The lineage ProposalModule: FPS over the votes, one QueryAndGroup
    (radius, nsample, use_xyz, normalize_xyz), a shared MLP (sa_channels)
    with a masked max-pool, then the Conv1d head. in_dim: vote feature
    channels. No scale logits: detection_loss leaves out the
    scale-selection term."""

    def __init__(self, num_classes: int, in_dim: int,
                 num_heading_bins: int = 12, num_proposals: int = 256,
                 radius: float = 0.3, nsample: int = 16,
                 sa_channels: Sequence[int] = (128, 128, 128),
                 feat_dim: int = 128):
        super().__init__()
        self.num_proposals = num_proposals
        self.radius = radius
        self.nsample = nsample
        self.sa_mlp = SharedMLP(3 + in_dim, tuple(sa_channels))
        _add_box_head(self, sa_channels[-1], feat_dim,
                      _out_channels(num_heading_bins, num_classes))

    def forward(self, vote_xyz, vote_features, *, vote_mask=None,
                bn_momentum=0.9):
        inds, center_mask = _fps_centers(vote_xyz, self.num_proposals,
                                         vote_mask)
        centers = ops.gather(vote_xyz, inds)  # [B, P, 3]
        grouped, _, gmask = ops.query_and_group(
            vote_xyz, centers, self.radius, self.nsample,
            features=vote_features, mask=vote_mask, use_xyz=True,
            normalize_xyz=True,
        )
        gmask = gmask & center_mask[:, :, None]
        h = self.sa_mlp(grouped, mask=gmask, bn_momentum=bn_momentum)
        feat = ops.masked_max(h, gmask, 2)  # [B, P, D]
        return {
            "proposal_xyz": centers,
            "proposal_inds": inds,
            "proposal_mask": center_mask,
            "raw_params": _box_head(self, feat, center_mask, bn_momentum),
        }
