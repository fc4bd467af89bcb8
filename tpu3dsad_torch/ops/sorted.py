"""Sorted ball query: the fast grouping tier (fast_mode='sorted'), the
counterpart of tpu3dsad/ops/pallas/ball_query.py::sorted_ball_query
(with _morton_codes and _spread_bits).

Exact ball query run on Z-order (Morton) sorted views of the points and
the centers, its indices mapped back to the caller's order. Membership and
counts are exact; only which K of more than K in-ball points fill the slots
differs from the first-K-in-index-order rule: the scan order is the sorted,
spatial one. Bitwise the reference's arithmetic:

  * invalid points move to 1e9 and get code 1 << 30 (they sort last);
  * the 256^3 grid is anchored to the bounding box of the valid points,
    inv_cell = 256 / max(max - min, 1e-6) in fp32; cells are clipped to
    [0, 255] before the int32 cast; bits spread in int32;
  * both sorts are stable; the inverse of the center permutation is a
    scatter of arange;
  * the exact tier runs on the sorted views with no mask (the 1e9 points
    can join no ball); indices map back through the permutation, empty
    balls give 0, rows return to the caller's center order.

One path: the Morton codes of points and centers (the op
tpu3dsad_torch::morton_codes), torch.sort(stable=True) of each (the
reference sorts in XLA, outside its kernel), then the ball query given
both permutations (the op tpu3dsad_torch::ball_query). The ops dispatch
by the tensor's device (ops._use_kernel, ops/library.py):

  * on the card, two kernel launches besides the sorts: the codes in one
    kernel (ops/cuda/ball_query.morton_codes), then the B3 kernel given
    the permutations: its pre-pass stages the points in Z order (masked
    ones never join a ball, as the 1e9 points cannot), its tile skip
    leaves out the tiles far from each center, and its epilogue writes
    the caller's indices and rows;
  * the plain versions: `z_keys`, then `permuted_ball_query`, which is
    the glue above in torch (`sorted_views`), the plain exact tier and
    `map_back`. The CPU and use_impl("plain") run them.

`launches` counts the calls that launched the kernels; the ball-query op
adds to it where it launches the scan given permutations (ops/library.py),
so an exported program counts its sorted calls too.
"""

from __future__ import annotations

import torch

from tpu3dsad_torch.ops import library
from tpu3dsad_torch.ops.args import check_ball_query
from tpu3dsad_torch.ops.plain import ball_query as plain_ball_query

# the reference engages the sorted tier only at support sizes >= 8192
# (_SORTED_MIN_N) and for K a multiple of its kernel's slot width 8 with
# K <= N (supported()); the port keeps the same gate, so both group the
# same layers this way
SORTED_MIN_N = 8192
SLOT_WIDTH = 8
_GRID = 256
_INVALID_CODE = 1 << 30

launches = 0


def applies(n: int, nsample: int) -> bool:
    """Whether a support of n points and K = nsample takes the sorted
    tier (fast grouping, mode 'sorted')."""
    return n >= SORTED_MIN_N and nsample % SLOT_WIDTH == 0 and nsample <= n


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    """int32 in [0, 256): bit i moves to bit 3i (one Morton component)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def _morton_codes(pts, mn, inv_cell) -> torch.Tensor:
    """[..., 3] fp32 -> int32 Z-order codes on the grid anchored at mn."""
    q = torch.clamp((pts - mn) * inv_cell, 0.0, 255.0).to(torch.int32)
    return (_spread_bits(q[..., 0]) | (_spread_bits(q[..., 1]) << 1)
            | (_spread_bits(q[..., 2]) << 2))


def z_keys(xyz, centers, mask=None):
    """-> (codes_x [B,N], codes_c [B,M]) int32: the Z-order keys of the
    points (1 << 30 where invalid) and of the centers, on the grid of the
    valid points' bounding box. The plain version of the kernel
    ops/cuda/ball_query.morton_codes."""
    B, N, _ = xyz.shape
    valid = (torch.ones(B, N, dtype=torch.bool, device=xyz.device)
             if mask is None else mask.bool())
    x = torch.where(valid[..., None], xyz.float(), 1e9)
    mn = torch.where(valid[..., None], x, 3e38).amin(1, keepdim=True)
    mx = torch.where(valid[..., None], x, -3e38).amax(1, keepdim=True)
    # a true division (python's 256.0 / t is 256 * reciprocal(t) in torch)
    inv_cell = torch.div(torch.full_like(mx, _GRID),
                         torch.clamp_min(mx - mn, 1e-6))
    codes_x = torch.where(valid, _morton_codes(x, mn, inv_cell),
                          _INVALID_CODE)
    return codes_x, _morton_codes(centers.float(), mn, inv_cell)


def sorted_views(xyz, centers, mask=None):
    """-> (xs [B,N,3], cs [B,M,3], perm [B,N], inv_c [B,M]): the points
    (invalid ones at 1e9) and centers in Z order; xs[b, k] is point
    perm[b, k], and center j sits at sorted row inv_c[b, j]."""
    codes_x, codes_c = z_keys(xyz, centers, mask)
    return permuted_views(xyz, centers, mask,
                          torch.sort(codes_x, dim=1, stable=True).indices,
                          torch.sort(codes_c, dim=1, stable=True).indices)


def permuted_views(xyz, centers, mask, perm, perm_c):
    """sorted_views' result for given permutations perm [B,N] and perm_c
    [B,M] of the points and of the centers."""
    B, N, _ = xyz.shape
    M = centers.shape[1]
    x = xyz.float() if mask is None else torch.where(
        mask.bool()[..., None], xyz.float(), 1e9)
    xs = torch.gather(x, 1, perm[..., None].expand(B, N, 3))
    cs = torch.gather(centers.float(), 1, perm_c[..., None].expand(B, M, 3))
    rows = torch.arange(M, device=xyz.device).expand(B, M)
    inv_c = torch.empty_like(perm_c).scatter_(1, perm_c, rows)
    return xs.contiguous(), cs.contiguous(), perm, inv_c


def map_back(idx_s, cnt_s, perm, inv_c):
    """Results on sorted views -> (idx [B,M,K] int32, cnt [B,M] int32) in
    the caller's point indices and center order; empty balls give 0."""
    B, M, K = idx_s.shape
    mapped = torch.gather(perm, 1, idx_s.reshape(B, M * K).long())
    mapped = torch.where(cnt_s[..., None] > 0, mapped.reshape(B, M, K), 0)
    idx = torch.gather(mapped, 1, inv_c[..., None].expand(B, M, K))
    return idx.int(), torch.gather(cnt_s, 1, inv_c).int()


def permuted_ball_query(xyz, centers, radius, nsample, mask, perm, perm_c):
    """The plain version of the kernel's scan given permutations: the exact
    tier on permuted_views, mapped back."""
    xs, cs, perm, inv_c = permuted_views(xyz, centers, mask, perm, perm_c)
    idx_s, cnt_s = plain_ball_query(xs, cs, radius, nsample)
    return map_back(idx_s, cnt_s, perm, inv_c)


def sorted_ball_query(xyz, centers, radius, nsample, *, mask=None):
    """xyz [B,N,3], centers [B,M,3] -> (idx [B,M,K] int32, cnt [B,M] int32)
    with exact membership and counts, slots in Z order."""
    check_ball_query(xyz, centers, nsample, mask)
    perm, perm_c = z_order(xyz, centers, mask)
    return library.ball_query(xyz, centers, radius, nsample, mask, perm,
                              perm_c)


def z_order(xyz, centers, mask=None):
    """(perm [B,N], perm_c [B,M]) int64, the stable sorts of the points'
    and the centers' Morton codes (the op tpu3dsad_torch::morton_codes: one
    kernel on the card, z_keys elsewhere)."""
    codes_x, codes_c = library.morton_codes(xyz, centers, mask)
    return (torch.sort(codes_x, dim=1, stable=True).indices,
            torch.sort(codes_c, dim=1, stable=True).indices)
