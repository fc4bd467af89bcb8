"""What 3DSSD's work costs by its definition (the 3DSSD cell's rooflines
and share of the peak), from the configuration's static shapes alone, as
portbench/counts does for the size-adaptive detector:

  * FLOPs: every Linear of one scene's forward, 2 per multiply-add, at the
    configuration's shapes (each level's centres x samples for the
    groupings; padding rows count, since they are computed);
  * F-FPS over n points of d values to m picks: n * d * 3 * (m - 1) fp32
    operations (a difference, a square and a sum for every value of every
    point in every round after the first), plus the points (d values
    each) and the mask read once and the picks written once;
  * D-FPS (B1) and the ball queries: the calls of one forward, each costed
    by portbench/counts's fps_cost and ball_query_cost, as the size-adaptive
    detector's are.

No count depends on how a kernel does its work (its plan, the padding of a
point's values to float4s), so no correct kernel reads above its
roofline.
"""

from __future__ import annotations

from portbench.counts import F32

FFPS_OPS_PER_VALUE_ROUND = 3


def level_points(model: dict, level: int) -> int:
    """The centres SA level `level` keeps (an "FS" sampler picks twice)."""
    return sum(m * (2 if mode == "FS" else 1) for mode, m in zip(
        model["ssd3d_fps_mods"][level], model["ssd3d_npoints"][level]))


def layers(model: dict) -> list[tuple[int, int, int]]:
    """(rows, in, out) of every Linear of one scene's forward."""
    out = []

    def stack(rows, ch, widths):
        for w in widths:
            out.append((rows, ch, w))
            ch = w
        return ch

    ch = model["ssd3d_point_features"]
    for level, scales in enumerate(model["ssd3d_mlps"]):
        M = level_points(model, level)
        widths = [stack(M * k, 3 + ch, c) for k, c in
                  zip(model["ssd3d_nsamples"][level], scales)]
        ch = stack(M, sum(widths), (model["ssd3d_aggregation"][level],))
    S = model["ssd3d_npoints"][-1][0]
    stack(S, ch, tuple(model["ssd3d_vote_channels"]) + (3,))
    cg = sum(stack(S * k, 3 + ch, c) for k, c in
             zip(model["ssd3d_cg_nsamples"], model["ssd3d_cg_mlps"]))
    width = stack(S, cg, model["ssd3d_shared_channels"])
    branch = tuple(model["ssd3d_branch_channels"])
    stack(S, width, branch + (model["num_classes"],))
    stack(S, width, branch + (6 + 2 * model["num_heading_bins"],))
    return out


def forward_flops(model: dict) -> float:
    """Matmul FLOPs of one scene's forward."""
    return float(sum(2 * r * i * o for r, i, o in layers(model)))


def ffps_calls(model: dict, B: int, N: int) -> list[dict]:
    """The F-FPS calls of one forward over B clouds of N points: each F-FPS
    or FS sampler's, over its index range of the level's input, by xyz and
    the input's features."""
    calls, n, ch = [], N, model["ssd3d_point_features"]
    for level in range(len(model["ssd3d_npoints"])):
        start = 0
        for mode, end, m in zip(model["ssd3d_fps_mods"][level],
                                model["ssd3d_fps_ranges"][level],
                                model["ssd3d_npoints"][level]):
            stop = n if end == -1 else end
            if mode in ("F-FPS", "FS"):
                calls.append({"B": B, "n": stop - start, "d": 3 + ch,
                              "m": m})
            start = stop
        n, ch = level_points(model, level), model["ssd3d_aggregation"][level]
    return calls


def dfps_calls(model: dict, B: int, N: int) -> list[dict]:
    """The D-FPS calls (B1) of one forward over B clouds of N points: each
    D-FPS or FS sampler's, over its index range of the level's input."""
    calls, n = [], N
    for level in range(len(model["ssd3d_npoints"])):
        start = 0
        for mode, end, m in zip(model["ssd3d_fps_mods"][level],
                                model["ssd3d_fps_ranges"][level],
                                model["ssd3d_npoints"][level]):
            stop = n if end == -1 else end
            if mode in ("D-FPS", "FS"):
                calls.append({"B": B, "n": stop - start, "m": m})
            start = stop
        n = level_points(model, level)
    return calls


def ball_query_calls(model: dict, B: int, N: int) -> list[dict]:
    """The ball queries of one forward: one a radius of each level, over
    the level's input around its centres, then one a radius of the
    candidate generation, over the last level's points around the votes."""
    calls, n = [], N
    for level, ks in enumerate(model["ssd3d_nsamples"]):
        m = level_points(model, level)
        calls += [{"B": B, "n": n, "m": m, "k": k} for k in ks]
        n = m
    S = model["ssd3d_npoints"][-1][0]
    return calls + [{"B": B, "n": n, "m": S, "k": k}
                    for k in model["ssd3d_cg_nsamples"]]


def ffps_cost(call: dict) -> tuple[float, float]:
    """(fp32 operations, bytes) of one F-FPS call."""
    B, n, d, m = call["B"], call["n"], call["d"], call["m"]
    ops = B * n * d * (m - 1) * FFPS_OPS_PER_VALUE_ROUND
    return float(ops), float(B * (n * d * F32 + n + m * F32))
