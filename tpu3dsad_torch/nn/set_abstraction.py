"""Set abstraction, SSG and MSG, and GroupAll
(tpu3dsad/nn/set_abstraction.py:63-134).

Sample (FPS) -> group (ball query at one or more radii) -> shared MLP ->
masked max-pool per group. Pad slots and groups around invalid centers
never win the pool. GroupAll pools the whole cloud into one feature.

3DSSD's levels (models/ssd3d.py) add three things, each off by default:
fusion sampling (`sampling`: D-FPS by xyz, F-FPS by xyz and the features,
or both, each over its own index range of the level's input, the picks
concatenated in order), an aggregation conv over the concatenated scales
(`aggregation`), and grouping around centres that are not the level's own
points (`group_at`); `eps` and `bias` reach the shared MLPs.

With cp_mesh (context parallelism), the N-touching half, FPS and the
grouping, runs point-sharded over the mesh's 'points' axis
(parallel/point_sharded.py: exact, so bitwise the unsharded path with
exact grouping); the MLP and the pool run replicated on every rank of the
points group.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from tpu3dsad_torch import ops
from tpu3dsad_torch.nn.mlp import SharedMLP
from tpu3dsad_torch.parallel import point_sharded as ps
from tpu3dsad_torch.parallel.mesh import shard_batch
from tpu3dsad_torch.utils import trace

# fusion sampling's modes: D-FPS (xyz), F-FPS (xyz and the features), FS
# (both over the same range, F's picks first)
SAMPLING_MODES = ("D-FPS", "F-FPS", "FS")


class SetAbstraction(nn.Module):
    """in_features: channels of the per-point features (0 for none).

    sampling (3DSSD): ((mode, end, picks), ...), each sampler over the
    index range from the previous one's end (0 for the first) to `end`
    (-1: the last point), its picks offset into the level's input; npoint
    is then their total. aggregation: the width of a Linear (with bias) +
    BN + ReLU over the concatenated scales, or None. eps, bias: the shared
    MLPs' BatchNorm eps and Linear bias."""

    def __init__(self, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 in_features: int = 0, use_xyz: bool = True,
                 normalize_xyz: bool = False, *,
                 sampling: Sequence[tuple[str, int, int]] | None = None,
                 aggregation: int | None = None, eps: float = 1e-5,
                 bias: bool = False):
        super().__init__()
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.use_xyz = use_xyz
        self.normalize_xyz = normalize_xyz
        self.sampling = None if sampling is None else tuple(
            (mode, int(end), int(m)) for mode, end, m in sampling)
        if self.sampling is not None:
            for mode, _, _ in self.sampling:
                if mode not in SAMPLING_MODES:
                    raise ValueError(f"sampling mode must be one of "
                                     f"{SAMPLING_MODES}, got {mode!r}")
            total = sum(m * (2 if mode == "FS" else 1)
                        for mode, _, m in self.sampling)
            if total != npoint:
                raise ValueError(f"the samplers pick {total} points, "
                                 f"npoint is {npoint}")
        # as ops.query_and_group builds it: xyz only, xyz + features, or
        # features only
        in_ch = 3 if in_features == 0 else in_features + 3 * use_xyz
        for s, channels in enumerate(mlps):
            self.add_module(f"mlp_{s}", SharedMLP(in_ch, channels, eps=eps,
                                                  bias=bias))
        self.out_channels = sum(c[-1] for c in mlps)
        self.aggregation = aggregation
        if aggregation is not None:
            self.agg = SharedMLP(self.out_channels, (aggregation,), eps=eps,
                                 bias=True)
            self.out_channels = aggregation

    def forward(self, xyz, features=None, *, mask=None, inds=None,
                bn_momentum=0.9, cp_mesh=None, cp_batch_axis=None):
        """xyz [B,N,3], features [B,N,C] -> (new_xyz [B,M,3],
        new_features [B,M,C'], inds [B,M], new_mask [B,M]).

        cp_mesh: run FPS and the grouping sharded over its 'points' axis.
        cp_batch_axis (hybrid DP x CP): the inputs are the global batch,
        split over that axis of cp_mesh; the outputs are this rank's
        rows."""
        if cp_mesh is not None:
            if self.sampling is not None:
                raise NotImplementedError(
                    "fusion sampling has no point-sharded path")
            return self._forward_cp(xyz, features, mask, inds, bn_momentum,
                                    cp_mesh, cp_batch_axis)
        if inds is None:
            inds = (ops.furthest_point_sample(xyz, self.npoint, mask=mask)
                    if self.sampling is None
                    else self.sample(xyz, features, mask))
        new_xyz = ops.gather(xyz, inds)
        new_mask = (torch.ones(inds.shape, dtype=torch.bool, device=xyz.device)
                    if mask is None else mask.bool().gather(1, inds.long()))
        return self._pool(xyz, features, mask, new_xyz, inds, new_mask,
                          bn_momentum, ops.query_and_group)

    def sample(self, xyz, features, mask):
        """Fusion sampling (the class docstring): picks [B, npoint] int32
        into the level's input xyz [B,N,3], features [B,N,C]."""
        N = xyz.shape[1]
        picks, start = [], 0
        for mode, end, m in self.sampling:
            stop = N if end == -1 else end
            part = None if mask is None else mask[:, start:stop]
            if mode in ("F-FPS", "FS"):
                vec = torch.cat([xyz[:, start:stop], features[:, start:stop]],
                                -1)
                with trace.span("sample.ffps"):
                    picks.append(ops.feature_furthest_point_sample(
                        vec, m, mask=part) + start)
            if mode in ("D-FPS", "FS"):
                with trace.span("sample.dfps"):
                    picks.append(ops.furthest_point_sample(
                        xyz[:, start:stop].contiguous(), m, mask=part)
                        + start)
            start = stop
        return torch.cat(picks, 1) if len(picks) > 1 else picks[0]

    def group_at(self, xyz, features, centers, *, mask=None,
                 center_mask=None, bn_momentum=0.9):
        """The level's grouping, MLPs and pool (and aggregation) around
        given centres [B,M,3], which need not be points of xyz [B,N,3]
        (3DSSD's candidate generation groups around the votes) ->
        features [B,M,C']."""
        if center_mask is None:
            center_mask = torch.ones(centers.shape[:2], dtype=torch.bool,
                                     device=centers.device)
        return self._pool(xyz, features, mask, centers, None, center_mask,
                          bn_momentum, ops.query_and_group)[1]

    def _forward_cp(self, xyz, features, mask, inds, bn_momentum, mesh,
                    batch_axis):
        if batch_axis is not None:
            rows = shard_batch({"xyz": xyz, "features": features,
                                "mask": mask, "inds": inds}, mesh, batch_axis)
            xyz, features, mask, inds = rows.values()
        if mask is None:
            mask = torch.ones(xyz.shape[:2], dtype=torch.bool,
                              device=xyz.device)
        if inds is None:
            inds = ps.sharded_fps(xyz, self.npoint, mesh, mask=mask)
        new_xyz, new_mask = ps.sharded_centers(xyz, inds, mesh, mask=mask)

        def group(xyz, centers, radius, nsample, **kw):
            return ps.sharded_query_and_group(xyz, centers, radius, nsample,
                                              mesh, **kw)

        return self._pool(xyz, features, mask, new_xyz, inds, new_mask,
                          bn_momentum, group)

    def _pool(self, xyz, features, mask, new_xyz, inds, new_mask,
              bn_momentum, query_and_group):
        pooled = []
        for s, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            grouped, _, gmask = query_and_group(
                xyz, new_xyz, radius, nsample, features=features, mask=mask,
                use_xyz=self.use_xyz, normalize_xyz=self.normalize_xyz,
            )
            gmask = gmask & new_mask[:, :, None]
            h = getattr(self, f"mlp_{s}")(grouped, mask=gmask,
                                          bn_momentum=bn_momentum)
            pooled.append(ops.masked_max(h, gmask, 2))
        new_features = torch.cat(pooled, -1) if len(pooled) > 1 else pooled[0]
        if self.aggregation is not None:
            new_features = self.agg(new_features, mask=new_mask,
                                    bn_momentum=bn_momentum)
        return new_xyz, new_features, inds, new_mask


class GroupAll(nn.Module):
    """Every point in one group: xyz and features concatenated, the shared
    MLP under the mask, then the masked max over points -> [B, C] (the
    last SA level of the classifier). in_features: channels of the
    per-point features (0 for none). The reference's use_xyz=False has no
    caller and is not ported."""

    def __init__(self, mlp: Sequence[int], in_features: int = 0):
        super().__init__()
        self.mlp = SharedMLP(in_features + 3, mlp)
        self.out_channels = mlp[-1]

    def forward(self, xyz, features=None, *, mask=None, bn_momentum=0.9):
        """xyz [B,N,3], features [B,N,C], mask [B,N] -> [B, mlp[-1]]; a
        cloud with no valid point pools to 0."""
        grouped = xyz if features is None else torch.cat([xyz, features], -1)
        gmask = (torch.ones(xyz.shape[:2], dtype=torch.bool,
                            device=xyz.device)
                 if mask is None else mask.bool())
        h = self.mlp(grouped, mask=gmask, bn_momentum=bn_momentum)
        return ops.masked_max(h, gmask, 1)
