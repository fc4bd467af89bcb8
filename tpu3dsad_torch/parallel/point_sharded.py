"""Point-axis (N) sharding over the ranks of a mesh axis: context
parallelism for giant clouds (tpu3dsad/parallel/point_sharded.py,
docs/context_parallel.md).

Each rank of the `axis` group holds a contiguous, equal shard of N and
runs the local op on it: the port's own exact ball query (B3 on the card)
and knn, and FPS's running-min update. Per-center candidates merge after
one small collective (M*K*p integers, against N-sized tensors). Shards
partition N in order, so global scan order is shard order, and every
result is exactly the unsharded op's: ball query's first K, FPS's picks
(ties to the lowest global index), knn's k nearest (ties to the lower
index).

Entry points take GLOBAL tensors and a mesh (parallel/mesh.py), as the
reference's do; each rank slices its shard. Hybrid DP x CP: with
`batch_axis`, the batch is split over that axis too and each rank keeps
and returns its rows of the batch (shard_batch's layout), while the
collectives run on the `axis` group only. batch_axis=None replicates the
batch: every rank of the group returns the whole result.

Gradients: a sum over the points group feeds a loss every rank of the
group computes alike, so its backward passes the gradient through
(collectives.replicated_sum), and the cut of a rank's shard out of a
replicated tensor sums the shards' gradients back over the group, so
every rank holds the whole gradient of its replicated inputs.

The FPS pick loop is latency-bound: each pick makes ONE collective, a
[B, 5] fp32 record (value, global index, the candidate's coordinates) from
every shard; the seed's coordinates are fetched once before the loop.
Indices ride fp32 exactly (N < 2^24). The local d2 is the plain FPS's
expression, (dx*dx + dy*dy) + dz*dz in separate eager fp32 ops
(ops/plain/fps.py), which is what the B1 kernel computes with
__fmul_rn / __fadd_rn, so the sharded picks are B1's bit for bit.
"""

from __future__ import annotations

import torch

from tpu3dsad_torch import ops
from tpu3dsad_torch.ops.plain.group import group_epilogue
from tpu3dsad_torch.parallel import collectives
from tpu3dsad_torch.parallel.mesh import take_rows


class _Shard(torch.autograd.Function):
    """x[:, lo:hi]; the backward pads the shard's gradient to x's shape
    and sums it over the points group."""

    @staticmethod
    def forward(ctx, x, lo, hi, group):
        ctx.lo, ctx.hi, ctx.n, ctx.group = lo, hi, x.shape[1], group
        return x[:, lo:hi]

    @staticmethod
    def backward(ctx, grad):
        full = grad.new_zeros((grad.shape[0], ctx.n, *grad.shape[2:]))
        full[:, ctx.lo:ctx.hi] = grad
        return collectives.all_reduce_sum(full, ctx.group), None, None, None


def _span(mesh, axis: str, n: int) -> tuple[int, int]:
    """[lo, hi) of this rank's shard of n points."""
    p = mesh.shape[axis]
    if n % p:
        raise ValueError(f"N = {n} does not split into {p} equal shards "
                         f"over the mesh axis {axis!r}")
    lo = mesh.axis_index(axis) * (n // p)
    return lo, lo + n // p


def _shard(x, mesh, axis: str):
    """This rank's shard of x [B, N, ...] along N (None stays None)."""
    if x is None:
        return None
    lo, hi = _span(mesh, axis, x.shape[1])
    if x.requires_grad:
        return _Shard.apply(x, lo, hi, mesh.group(axis))
    return x[:, lo:hi]


def _rows(mesh, batch_axis, *tensors):
    """Each tensor's rows of this rank on batch_axis (all of them where it
    is None)."""
    if batch_axis is None:
        return tensors
    i, p = mesh.axis_index(batch_axis), mesh.shape[batch_axis]
    return tuple(take_rows(t, i, p) for t in tensors)


def _ones_mask(xyz):
    return torch.ones(xyz.shape[:2], dtype=torch.bool, device=xyz.device)


# ------------------------------------------------------------- ball query


def _merge_scan_order(all_idx, all_cnt, nsample: int):
    """Per-shard first-K lists -> the global first K.

    all_idx [p,B,M,K] (global indices, in scan order within each shard),
    all_cnt [p,B,M]. Shards partition N in order, so concatenating them in
    shard order keeps global scan order: take the first K valid, pad with
    the first hit, 0 for an empty ball."""
    p, B, M, K = all_idx.shape
    cand = all_idx.permute(1, 2, 0, 3).reshape(B, M, p * K)
    slot = torch.arange(K, device=all_idx.device)
    valid = (slot < all_cnt[..., None]).permute(1, 2, 0, 3).reshape(
        B, M, p * K)
    # the first K valid by the descending-score trick of the exact tier
    order = torch.arange(p * K, 0, -1, dtype=torch.int32,
                         device=all_idx.device)
    score = torch.where(valid, order, 0)
    top, pos = score.topk(min(nsample, p * K), dim=-1)
    hit = top > 0
    sel = torch.gather(cand, -1, pos)
    idx = torch.where(hit, sel, sel[..., :1])
    idx = torch.where(hit.any(-1, keepdim=True), idx, 0)
    cnt = valid.sum(-1).clamp_max(nsample)
    return idx.int(), cnt.int()


def _ball_query_local(xyz, centers, radius, nsample, mesh, mask, axis):
    lo, _ = _span(mesh, axis, xyz.shape[1])
    idx_l, cnt_l = ops.ball_query(_shard(xyz, mesh, axis), centers, radius,
                                  nsample, mask=_shard(mask, mesh, axis),
                                  exact=True)
    # one collective: the candidates with their count beside them
    rec = torch.cat([idx_l + lo, cnt_l[..., None]], -1)
    got = collectives.all_gather(rec, mesh.group(axis))
    return _merge_scan_order(got[..., :-1], got[..., -1], nsample)


def sharded_ball_query(xyz, centers, radius: float, nsample: int, mesh,
                       mask=None, axis: str = "points",
                       batch_axis: str | None = None):
    """Exact ball query with N sharded over `axis`: xyz [B,N,3] (N a
    multiple of the axis size), centers [B,M,3] -> (idx [B,M,K] int32
    GLOBAL indices, cnt [B,M] int32), equal to ops.ball_query(...,
    exact=True)."""
    if mask is None:
        mask = _ones_mask(xyz)
    xyz, centers, mask = _rows(mesh, batch_axis, xyz, centers, mask)
    return _ball_query_local(xyz.detach(), centers.detach(), radius, nsample,
                             mesh, mask, axis)


# -------------------------------------------------------------------- FPS


def _fps_local(xyz, npoint, mesh, mask, axis):
    B, N, _ = xyz.shape
    if N >= 1 << 24:
        raise ValueError("sharded_fps: global indices ride fp32 exactly "
                         "only below 2^24 points")
    group = mesh.group(axis)
    lo, hi = _span(mesh, axis, N)
    xyz_l = xyz[:, lo:hi].float()
    valid = mask[:, lo:hi].bool()
    glane = torch.arange(lo, hi, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    # the seed, global index 0, lives on the first shard: its coordinates
    # are the sum of that shard's and zeros (exact)
    seed = xyz_l[:, 0] if lo == 0 else torch.zeros_like(xyz_l[:, 0])
    last = collectives.replicated_sum(seed, group)
    dist = torch.where(valid, torch.inf, -torch.inf)
    idx = torch.zeros(B, npoint, dtype=torch.int32, device=xyz.device)
    big = torch.tensor(N, device=xyz.device)
    for i in range(1, npoint):
        d = xyz_l - last[:, None, :]
        dx, dy, dz = d.unbind(-1)
        d2 = dx * dx + dy * dy + dz * dz
        dist = torch.minimum(dist, torch.where(valid, d2, -torch.inf))
        lbest = dist.amax(1)
        lidx = torch.where(dist == lbest[:, None], glane, big).amin(1)
        payload = torch.cat([lbest[:, None], lidx[:, None].float(),
                             xyz_l[rows, lidx - lo]], 1)
        rec = collectives.all_gather(payload, group)  # [p, B, 5]
        vals, fids = rec[..., 0], rec[..., 1]
        best = vals.amax(0)
        g = torch.where(vals == best, fids, float(N)).amin(0)
        # the one shard that proposed g (shard ranges are disjoint)
        win = ((vals == best) & (fids == g)).int().argmax(0)
        last = rec[win, rows, 2:5]
        idx[:, i] = g.int()
    return idx


def sharded_fps(xyz, npoint: int, mesh, mask=None, axis: str = "points",
                batch_axis: str | None = None):
    """Exact FPS with N sharded over `axis`: xyz [B,N,3] -> idx [B,npoint]
    int32 global, equal to ops.furthest_point_sample (seed index 0, ties
    to the lowest global index, masked points never picked). One
    collective a pick (module docstring)."""
    if mask is None:
        mask = _ones_mask(xyz)
    xyz, mask = _rows(mesh, batch_axis, xyz, mask)
    with torch.no_grad():
        return _fps_local(xyz, npoint, mesh, mask, axis)


# -------------------------------------------------------------------- kNN


def sharded_knn(query, support, k: int, mesh, support_mask=None,
                axis: str = "points", batch_axis: str | None = None):
    """Exact kNN with the support sharded over `axis`: query [B,M,3],
    support [B,N,3] -> (d2 [B,M,k] fp32, idx [B,M,k] int32 global), equal
    to ops.knn(query, support, k, support_mask=...)."""
    if support_mask is None:
        support_mask = _ones_mask(support)
    query, support, support_mask = _rows(mesh, batch_axis, query, support,
                                         support_mask)
    lo, _ = _span(mesh, axis, support.shape[1])
    sup_l = _shard(support.detach(), mesh, axis)
    k_eff = min(k, sup_l.shape[1])
    d2, idx = ops.knn(query.detach(), sup_l, k_eff,
                      support_mask=_shard(support_mask, mesh, axis))
    # one collective: distances and global indices (exact in fp32)
    rec = torch.stack([d2, (idx + lo).float()], -1)
    got = collectives.all_gather(rec, mesh.group(axis))  # [p,B,M,k,2]
    p, B, M = got.shape[:3]
    cd = got[..., 0].permute(1, 2, 0, 3).reshape(B, M, -1)
    ci = got[..., 1].permute(1, 2, 0, 3).reshape(B, M, -1)
    # a stable sort: ties within a shard are already low-index first, and
    # the shard-major order is global index order across shards
    cd, order = torch.sort(cd, dim=-1, stable=True)
    return cd[..., :k], torch.gather(ci, -1, order[..., :k]).int()


# --------------------------------------------------------------- grouping


def _group_local(points, idx, mesh, axis):
    """points [B,N,C] (global N), idx [B,M,K] global -> [B,M,K,C]: each
    rank gathers the indices in its shard, the rest add zero, and one sum
    over the group combines them."""
    lo, hi = _span(mesh, axis, points.shape[1])
    pts_l = _shard(points, mesh, axis)
    local = idx.long() - lo
    mine = (local >= 0) & (local < hi - lo)
    gathered = ops.group(pts_l, local.clamp(0, hi - lo - 1))
    contrib = torch.where(mine[..., None], gathered, 0.0)
    return collectives.replicated_sum(contrib, mesh.group(axis))


def sharded_group(points, idx, mesh, axis: str = "points",
                  batch_axis: str | None = None):
    """Gather [B,M,K] GLOBAL indices from N-sharded points [B,N,C], with no
    N-sized gather onto one rank: equal to ops.group(points, idx)."""
    points, idx = _rows(mesh, batch_axis, points, idx)
    return _group_local(points, idx, mesh, axis)


def _query_and_group_local(xyz, centers, radius, nsample, mesh, features,
                           mask, use_xyz, normalize_xyz, axis):
    idx, cnt = _ball_query_local(xyz.detach(), centers.detach(), radius,
                                 nsample, mesh, mask, axis)
    src = xyz if features is None else torch.cat([xyz, features], -1)
    grouped, group_mask = group_epilogue(
        _group_local(src, idx, mesh, axis), centers, cnt, radius, nsample,
        has_features=features is not None, use_xyz=use_xyz,
        normalize_xyz=normalize_xyz)
    return grouped, idx, group_mask


def sharded_query_and_group(xyz, centers, radius: float, nsample: int, mesh,
                            features=None, mask=None, use_xyz: bool = True,
                            normalize_xyz: bool = False, axis: str = "points",
                            batch_axis: str | None = None):
    """query_and_group with N sharded over `axis`: (grouped [B,M,K,...],
    idx [B,M,K], group_mask [B,M,K]), equal to ops.query_and_group(...,
    exact=True)."""
    if mask is None:
        mask = _ones_mask(xyz)
    xyz, centers, features, mask = _rows(mesh, batch_axis, xyz, centers,
                                         features, mask)
    return _query_and_group_local(xyz, centers, radius, nsample, mesh,
                                  features, mask, use_xyz, normalize_xyz,
                                  axis)


def _centers_local(xyz, inds, mesh, mask, axis):
    src = torch.cat([xyz, mask[..., None].to(xyz.dtype)], -1)
    g = _group_local(src, inds[..., None], mesh, axis)[:, :, 0, :]
    return g[..., :3], g[..., 3] > 0.5


def sharded_centers(xyz, inds, mesh, mask=None, axis: str = "points",
                    batch_axis: str | None = None):
    """The sampled centers and their validity from the sharded cloud, in
    ONE collective (xyz and the mask bit ride one sharded gather):
    (new_xyz [B,M,3], new_mask [B,M])."""
    if mask is None:
        mask = _ones_mask(xyz)
    xyz, inds, mask = _rows(mesh, batch_axis, xyz, inds, mask)
    return _centers_local(xyz, inds, mesh, mask, axis)


def sharded_sa_stage(xyz, features, npoint: int, radius: float,
                     nsample: int, mesh, mask=None,
                     normalize_xyz: bool = True, axis: str = "points",
                     batch_axis: str | None = None):
    """The N-touching half of a SetAbstraction layer on an N-sharded cloud:
    sharded FPS -> center gather -> sharded query_and_group. The shared
    MLP and the masked max over [B,M,K,C] are N-free and run replicated.
    Returns (new_xyz, grouped, inds, group_mask, new_mask)."""
    if mask is None:
        mask = _ones_mask(xyz)
    xyz, features, mask = _rows(mesh, batch_axis, xyz, features, mask)
    with torch.no_grad():
        inds = _fps_local(xyz, npoint, mesh, mask, axis)
    new_xyz, new_mask = _centers_local(xyz, inds, mesh, mask, axis)
    grouped, _, gmask = _query_and_group_local(
        xyz, new_xyz, radius, nsample, mesh, features, mask, True,
        normalize_xyz, axis)
    return new_xyz, grouped, inds, gmask & new_mask[:, :, None], new_mask
