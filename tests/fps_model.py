"""A numpy model of the FPS kernel template (csrc/fps.cu), stage by stage,
for the CPU tests (tests/test_torch_fps_plan.py) and the card tests
(tests/test_torch_kitti_fit.py: the kernel's engaged counter). It imports
neither JAX nor the JAX package, so a `card` file may use it.

`model_fps` repeats the kernel's arithmetic: each thread's points in the
order the kernel gives them (register tier: r*S + k*T + t; memory tier: a
stride of T over the slice; B2's pruned pass: the pre-pass's slabs dealt
to the warps), the thread's best (order-preserving distance bits, key),
then the warp's, the CTA's and the cluster's by "max bits, then min key
among the holders of the max". The pruned pass keeps each warp's box and
cached key and skips the warp's pass where the fp32 lower bound from the
pick to the box is at least the warp's largest running distance; a
skipped warp's distances are left as they were, so a skip that would
have changed one shows as another pick.
"""

import numpy as np

NONE = np.uint32(0xFFFFFFFF)  # the key of an empty partial
SLOT_BITS = 13  # the pruned pass's key: original index << 13 | slot


def ordered(d):
    """The kernel's order-preserving bits of float32 distances."""
    u = np.asarray(d, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def unordered(u):
    """The float32 of ordered() bits."""
    u = np.asarray(u, np.uint32)
    return np.where(u & 0x80000000, u & 0x7FFFFFFF, ~u).astype(
        np.uint32).view(np.float32)


def reduce(bits, key, axis):
    """(max bits, min key among the entries that hold it) along axis: the
    two redux.sync reductions of a stage."""
    top = bits.max(axis=axis)
    held = bits == np.expand_dims(top, axis)
    return top, np.where(held, key, NONE).min(axis=axis)


def slabs(codes, slab: int = 512):
    """The pruned pass's pre-pass on Z-order keys, in numpy: a stable sort,
    cut into slabs of `slab` indices, each ascending, padded with N."""
    n = len(codes)
    perm = np.argsort(np.asarray(codes), kind="stable")
    order = np.concatenate([perm, np.full(-n % slab, n)])
    return np.sort(order.reshape(-1, slab), axis=1).reshape(-1).astype(
        np.int32)


def _gap(lo, l, hi):
    """The pick's fp32 distance outside [lo, hi] on each axis."""
    return np.where(l < lo, lo - l,
                    np.where(l > hi, l - hi, np.float32(0))).astype(
                        np.float32)


def model_fps(xyz, m, mask, p, order=None):
    """One cloud's picks as fps_cluster_kernel<p.points> makes them with
    p.cluster CTAs of p.threads threads, or, given the pre-pass's `order`,
    fps_cluster_kernel_pruned<16>: xyz [N, 3] float32 -> (picks [m], the
    warp-rounds that ran their pass)."""
    n = xyz.shape[0]
    C, T, P = p
    valid = np.ones(n, bool) if mask is None else mask.astype(bool)
    if order is not None:  # slab w*C + r: warp w of CTA r; element k*32 + t
        W = T // 32
        slab = np.arange(W)[None, None, :, None] * C \
            + np.arange(C)[:, None, None, None]
        e = (slab * P + np.arange(P)[None, :, None, None]) * 32 \
            + np.arange(32)
        g = np.where(e < len(order), order[np.minimum(e, len(order) - 1)],
                     n).reshape(C, P, T)
        present = np.ones(g.shape, bool)
        slot = np.arange(P)[:, None] * T + np.arange(T)
        key = (g.astype(np.uint32) << SLOT_BITS) | slot.astype(np.uint32)
    elif P:  # thread t of CTA r holds points r*S + k*T + t, k < P; S = T*P
        g = np.arange(C * T * P).reshape(C, P, T)
        present = np.ones(g.shape, bool)  # pads (g >= n) are -inf points
        key = g.astype(np.uint32)
    else:  # thread t walks j = t, t + T, ... < S; S = ceil(N / C)
        S = -(-n // C)
        j = np.arange(-(-S // T))[:, None] * T + np.arange(T)
        g = np.arange(C)[:, None, None] * S + j
        present = (j < S) & (g < n)
        key = g.astype(np.uint32)
    real = g < n
    pts = np.where(real[..., None], xyz[np.where(real, g, 0)], 0)
    pts = pts.astype(np.float32)
    d = np.where(real & valid[np.where(real, g, 0)], np.inf, -np.inf)
    d = d.astype(np.float32)

    def warps(a):  # [C, J, T, ...] -> [C, T // 32, J * 32, ...]
        a = a.reshape(C, a.shape[1], T // 32, 32, *a.shape[3:])
        return np.swapaxes(a, 1, 2).reshape(C, T // 32, -1, *a.shape[4:])

    def warp_keys(d):
        # thread: its first point of the highest bits (strict > in order)
        bits = np.where(present, ordered(d), 0).astype(np.uint32)
        k = bits.argmax(axis=1)[:, None]
        tb = np.take_along_axis(bits, k, 1)[:, 0]  # [C, T]
        tk = np.where(tb > 0, np.take_along_axis(key, k, 1)[:, 0], NONE)
        return reduce(tb.reshape(C, T // 32, 32),
                      tk.reshape(C, T // 32, 32).astype(np.uint32), 2)

    cache = warp_keys(d)
    if order is not None:  # each warp's box of its points not at -inf
        keep = warps(d != -np.inf)[..., None]
        box_lo = np.fmin.reduce(np.where(keep, warps(pts), np.inf), axis=2)
        box_hi = np.fmax.reduce(np.where(keep, warps(pts), -np.inf), axis=2)
    picks, last, engaged = [0], xyz[0], 0
    with np.errstate(invalid="ignore", over="ignore"):
        for _ in range(1, m):
            run = np.ones((C, T // 32), bool)
            if order is not None:
                gp = _gap(box_lo, last, box_hi)
                lb = (gp[..., 0] * gp[..., 0] + gp[..., 1] * gp[..., 1]
                      ) + gp[..., 2] * gp[..., 2]
                run = ~(lb >= unordered(cache[0]))
            diff = pts - last
            d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
                  ) + diff[..., 2] * diff[..., 2]
            d = np.where(np.repeat(run, 32, axis=1)[:, None, :],
                         np.fmin(d, d2), d)  # fminf keeps d over a NaN
            wb, wk = warp_keys(d)
            cache = (np.where(run, wb, cache[0]), np.where(run, wk, cache[1]))
            engaged += int(run.sum())
            # CTA (its warps), cluster (its CTAs)
            cb, ck = reduce(*cache, 1)
            _, win = reduce(cb, ck, 0)
            pick = int(win >> SLOT_BITS) if order is not None else int(win)
            assert pick < n, "a pad or an empty CTA won"
            picks.append(pick)
            last = xyz[pick]  # the winner's xyz travels with its partial
    return np.array(picks), engaged
