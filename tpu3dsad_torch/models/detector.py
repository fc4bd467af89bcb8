"""SizeAdaptiveDetector — the flagship model (tpu3dsad/models/detector.py).

Backbone -> voting -> proposal (the size-adaptive head, or the lineage
head with model.proposal_mode='lineage') -> decoded end_points dict. The
height feature (z minus the floor of the scene's valid points) is computed
in the model when cfg.append_height is set.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpu3dsad_torch.config import ModelConfig, class_mean_sizes
from tpu3dsad_torch.models.backbone import PointNet2Backbone
from tpu3dsad_torch.models.decode import decode_proposals
from tpu3dsad_torch.models.proposal import (
    LineageProposal,
    SizeAdaptiveProposal,
)
from tpu3dsad_torch.models.voting import VotingModule
from tpu3dsad_torch.nn.mlp import init_like_flax_
from tpu3dsad_torch.parallel.mesh import shard_batch
from tpu3dsad_torch.utils import trace


class SizeAdaptiveDetector(nn.Module):
    """cfg: a ModelConfig (the port's or the reference's). mean_sizes
    [NS,3]: dataset size priors, else the synthetic ones. in_features: raw
    per-point feature channels (color) besides the height. Weights are
    drawn as a fresh flax model's would be, from `generator` (a CPU
    torch.Generator; seed 0 if None), then the module is moved to `device`:
    the card unless the caller asks for the CPU. Built for "cuda" where
    there is no card, it raises.

    In training mode (`model.train()`), BatchNorm uses the masked batch
    statistics and updates its running averages with `bn_momentum`, and the
    proposal head blends the radius bank by softmax."""

    def __init__(self, cfg: ModelConfig, mean_sizes=None, *,
                 in_features: int = 0, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.mean_sizes = (class_mean_sizes(cfg.num_classes)
                           if mean_sizes is None
                           else np.asarray(mean_sizes, np.float32))
        ch = in_features + int(cfg.append_height)
        self.backbone = PointNet2Backbone(cfg, ch)
        seed_dim = cfg.fp_channels[1][-1]
        self.voting = VotingModule(seed_dim, cfg.vote_factor,
                                   cfg.seed_feat_dim)
        if cfg.proposal_mode == "lineage":
            # the fixed-radius lineage head, which lineage checkpoints
            # import into
            self.proposal = LineageProposal(
                num_classes=cfg.num_classes, in_dim=seed_dim,
                num_heading_bins=cfg.num_heading_bins,
                num_proposals=cfg.num_proposals,
                radius=cfg.proposal_radius, nsample=cfg.cluster_nsample)
        else:
            self.proposal = SizeAdaptiveProposal(
                num_classes=cfg.num_classes, in_dim=seed_dim,
                num_heading_bins=cfg.num_heading_bins,
                num_proposals=cfg.num_proposals,
                radius_bank=tuple(cfg.cluster_radius_bank),
                nsample=cfg.cluster_nsample, sampling=cfg.proposal_sampling,
                density_radius=cfg.proposal_density_radius,
                candidate_factor=cfg.proposal_candidate_factor)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_like_flax_(self, generator)
        self.eval()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SizeAdaptiveDetector(device='cuda'): no CUDA device is "
                "available; pass device='cpu' to build it on the CPU")
        self.to(device)

    def forward(self, points, features=None, *, mask=None, bn_momentum=0.9,
                cp_mesh=None, cp_batch_axis=None):
        """points [B,N,3], features [B,N,C] -> end_points dict.

        cp_mesh (context parallelism; every rank of the mesh calls forward
        with the same inputs): the first cfg.cp_stages SA levels run
        point-sharded over its 'points' axis (models/backbone.py), exactly
        as the unsharded forward with exact grouping. cp_batch_axis (hybrid
        DP x CP on a 2-D mesh): the inputs are the global batch, split over
        that axis, and the end_points are this rank's rows."""
        if cp_mesh is not None and cp_batch_axis is not None:
            rows = shard_batch({"points": points, "features": features,
                                "mask": mask}, cp_mesh, cp_batch_axis)
            points, features, mask = rows.values()
        parts = [] if features is None else [features]
        if self.cfg.append_height:
            z = points[..., 2:3]
            valid = (torch.ones_like(z, dtype=torch.bool) if mask is None
                     else mask.bool()[..., None])
            floor = torch.where(valid, z, torch.inf).amin(1, keepdim=True)
            parts.append(z - floor)
        features = torch.cat(parts, -1) if parts else None

        with trace.span("detector.backbone"):
            end_points = dict(self.backbone(points, features, mask=mask,
                                            bn_momentum=bn_momentum,
                                            cp_mesh=cp_mesh))
        with trace.span("detector.voting"):
            vote_xyz, vote_feat, vote_mask = self.voting(
                end_points["seed_xyz"], end_points["seed_features"],
                mask=end_points["seed_mask"], bn_momentum=bn_momentum)
        end_points["vote_xyz"] = vote_xyz
        end_points["vote_features"] = vote_feat
        end_points["vote_mask"] = vote_mask
        with trace.span("detector.proposal"):
            prop = self.proposal(vote_xyz, vote_feat, vote_mask=vote_mask,
                                 bn_momentum=bn_momentum)
            end_points.update(prop)
            end_points.update(decode_proposals(
                prop["raw_params"], prop["proposal_xyz"], self.mean_sizes,
                self.cfg.num_heading_bins))
        return end_points
