"""Oriented BEV IoU — plain PyTorch version of csrc/iou.cu.

The reference's oriented_bev_iou (tpu3dsad/ops/boxes.py), XLA there, is a
chain of elementwise torch ops here: four Sutherland-Hodgman steps of about
20 ops each over every pair's padded polygon, then the shoelace and the z
overlap.
"""

from __future__ import annotations

import torch


def _take(poly, idx):
    """poly[..., idx, :] along the vertex axis, NaN where idx is past the
    buffer (jnp.take_along_axis's fill, which the reference relies on)."""
    V = poly.shape[-2]
    got = torch.gather(poly, -2, idx.clamp_max(V - 1)[..., None].expand(
        *idx.shape, 2))
    return torch.where((idx < V)[..., None], got, torch.nan)


def _shoelace(poly, n):
    """Signed area x2 of padded polygons. poly [..., V, 2], n [...] int."""
    V = poly.shape[-2]
    iota = torch.arange(V, device=poly.device)
    n = n[..., None]
    valid = iota < n
    nxt = torch.where(n > 0, torch.remainder(iota + 1, n.clamp_min(1)), 0)
    p_next = _take(poly, nxt.expand(*poly.shape[:-1]))
    terms = poly[..., 0] * p_next[..., 1] - p_next[..., 0] * poly[..., 1]
    return torch.where(valid, terms, 0.0).sum(-1)


def _clip_edge(poly, n, a, b):
    """One Sutherland-Hodgman step: clip the padded polygon against the
    edge a->b (inside = left of a->b, for CCW clip quads). poly [..., V, 2],
    n [...].

    The emitted vertices are compacted by a scatter on their slots where
    the reference multiplies by a [..., 2V, V] one-hot (which adds only
    exact zeros, so the values are the same); emissions past the buffer
    are dropped in both."""
    V = poly.shape[-2]
    iota = torch.arange(V, device=poly.device)
    n_ = n[..., None]
    valid = iota < n_
    prev = torch.where(n_ > 0, torch.remainder(iota - 1, n_.clamp_min(1)), 0)
    s = _take(poly, prev.expand(*poly.shape[:-1]))
    e = poly
    d = (b - a)[..., None, :]

    def side(p):
        r = p - a[..., None, :]
        return d[..., 0] * r[..., 1] - d[..., 1] * r[..., 0]

    side_s, side_e = side(s), side(e)
    in_s = side_s >= 0.0
    in_e = side_e >= 0.0
    denom = side_s - side_e
    t = side_s / torch.where(denom.abs() > 1e-12, denom, 1e-12)
    ipt = s + t[..., None] * (e - s)

    # the sequential emit order of each input edge: [intersection?, end?]
    emit1 = valid & (in_e != in_s)
    emit2 = valid & in_e
    lead = poly.shape[:-2]
    cand = torch.stack([ipt, e], -2).reshape(*lead, 2 * V, 2)
    emit = torch.stack([emit1, emit2], -1).reshape(*lead, 2 * V)
    pos = emit.cumsum(-1) - 1  # the slot of each emitted candidate
    new_n = emit.sum(-1).int()
    slot = torch.where(emit & (pos < V), pos, V)  # V: a slot thrown away
    new_poly = poly.new_zeros(*lead, V + 1, 2).scatter_(
        -2, slot[..., None].expand(*lead, 2 * V, 2), cand)
    return new_poly[..., :V, :], new_n


def oriented_bev_iou(corners_a: torch.Tensor, corners_b: torch.Tensor):
    """Pairwise IoU of oriented 3D boxes from [...,K,8,3] / [...,L,8,3]
    corners (box_corners convention: top face 0-3 CCW, Z-up) -> [...,K,L]:
    the BEV polygon clip times the z-extent overlap, the geometry of
    eval/ap.py::box3d_iou_oriented. The polygon buffer is 8 wide, exact,
    since clipping a quad by 4 half-planes gives at most 8 vertices."""
    qa = corners_a[..., :, None, :4, :2]  # subject [...,K,1,4,2]
    qb = corners_b[..., None, :, :4, :2]  # clip    [...,1,L,4,2]
    shape = torch.broadcast_shapes(qa.shape[:-2], qb.shape[:-2])
    qa = qa.expand(*shape, 4, 2)
    qb = qb.expand(*shape, 4, 2)

    poly = torch.cat([qa, qa.new_zeros(*shape, 4, 2)], -2)
    n = torch.full(shape, 4, dtype=torch.int32, device=qa.device)
    for i in range(4):
        poly, n = _clip_edge(poly, n, qb[..., i, :], qb[..., (i + 1) % 4, :])
    inter2d = 0.5 * _shoelace(poly, n).abs()

    za = corners_a[..., :, None, :, 2]
    zb = corners_b[..., None, :, :, 2]
    inter_h = (torch.minimum(za.amax(-1), zb.amax(-1))
               - torch.maximum(za.amin(-1), zb.amin(-1))).clamp_min(0.0)
    inter = inter2d * inter_h

    def volume(c):
        four = torch.full(c.shape[:-2], 4, dtype=torch.int32,
                          device=c.device)
        area = 0.5 * _shoelace(c[..., :4, :2], four).abs()
        return area * (c[..., 2].amax(-1) - c[..., 2].amin(-1))

    union = volume(corners_a)[..., :, None] + volume(corners_b)[..., None, :] \
        - inter
    return torch.where(union > 1e-12, inter / union.clamp_min(1e-12), 0.0)
