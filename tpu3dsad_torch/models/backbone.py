"""PointNet++ detection backbone: 4×SA + 2×FP -> seeds
(tpu3dsad/models/backbone.py)."""

from __future__ import annotations

import torch
from torch import nn

from tpu3dsad_torch.config import ModelConfig
from tpu3dsad_torch.nn import FeaturePropagation, SetAbstraction
from tpu3dsad_torch.parallel.mesh import shard_batch
from tpu3dsad_torch.utils import trace

# the spans of the levels, named once (an f-string would allocate per call
# with the tracer off)
_SA_SPANS = tuple(f"backbone.sa{i + 1}" for i in range(4))


class PointNet2Backbone(nn.Module):
    """in_features: per-point feature channels fed to SA1 (0 for none)."""

    def __init__(self, cfg: ModelConfig, in_features: int = 0):
        super().__init__()
        self.cp_stages = cfg.cp_stages
        if len(cfg.sa_npoints) != 4:
            raise ValueError("the detection backbone has 4 SA levels")
        ch = in_features
        for i in range(4):
            sa = SetAbstraction(
                npoint=cfg.sa_npoints[i], radii=(cfg.sa_radii[i],),
                nsamples=(cfg.sa_nsamples[i],),
                mlps=(tuple(cfg.sa_channels[i]),), in_features=ch,
                normalize_xyz=True,
            )
            self.add_module(f"sa{i + 1}", sa)
            ch = sa.out_channels
        c2, c3, c4 = (cfg.sa_channels[i][-1] for i in (1, 2, 3))
        self.fp1 = FeaturePropagation(c3 + c4, cfg.fp_channels[0])
        self.fp2 = FeaturePropagation(c2 + cfg.fp_channels[0][-1],
                                      cfg.fp_channels[1])

    def forward(self, xyz, features=None, *, mask=None, bn_momentum=0.9,
                cp_mesh=None, cp_batch_axis=None):
        """Returns dict with seed_xyz [B,S,3], seed_features [B,S,D],
        seed_inds [B,S], seed_mask [B,S] (S = cfg.sa_npoints[1]).

        cp_mesh: the first cfg.cp_stages SA levels run FPS and the grouping
        point-sharded over its 'points' axis; after them M is small and
        everything runs replicated. Exact, so bitwise the unsharded path
        with exact grouping. cp_batch_axis (hybrid DP x CP): the inputs are
        the global batch, and the outputs this rank's rows of it."""
        if cp_mesh is not None and cp_batch_axis is not None:
            rows = shard_batch({"xyz": xyz, "features": features,
                                "mask": mask}, cp_mesh, cp_batch_axis)
            xyz, features, mask = rows.values()
        sa_out = []  # (xyz, feats, inds, mask) per level
        cur = (xyz, features, None, mask)
        for i in range(4):
            cp = cp_mesh if i < self.cp_stages else None
            with trace.span(_SA_SPANS[i]):
                cur = getattr(self, f"sa{i + 1}")(cur[0], cur[1],
                                                  mask=cur[3],
                                                  bn_momentum=bn_momentum,
                                                  cp_mesh=cp)
            sa_out.append(cur)
        x2, f2, i2, m2 = sa_out[1]
        x3, f3, _, m3 = sa_out[2]
        x4, f4, _, m4 = sa_out[3]
        with trace.span("backbone.fp1"):
            f3p = self.fp1(x3, f3, x4, f4, dense_mask=m3, sparse_mask=m4,
                           bn_momentum=bn_momentum)
        with trace.span("backbone.fp2"):
            seeds = self.fp2(x2, f2, x3, f3p, dense_mask=m2, sparse_mask=m3,
                             bn_momentum=bn_momentum)
        # seed indices into the ORIGINAL cloud: sa1's picks composed with
        # sa2's (indices into sa1's set)
        seed_inds = torch.gather(sa_out[0][2], 1, i2.long())
        return {
            "seed_xyz": x2,
            "seed_features": seeds,
            "seed_inds": seed_inds,
            "seed_mask": m2,
            "sa1_xyz": sa_out[0][0],
            "sa1_inds": sa_out[0][2],
        }
