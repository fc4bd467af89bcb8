"""What the detector's work costs by its definition: the matmul FLOPs of a
scene, and the operations and bytes of each FPS, ball-query and scatter
call, from the configuration's static shapes alone.

No count depends on how a kernel does its work (its plan, the tiles it
keeps, its launches), so no correct kernel can read above its roofline:

  * FPS over n points to m picks: n * (m - 1) * 10 fp32 operations (the
    distance to the newest pick, 3 subtractions, 3 products, 2 additions,
    the running minimum and the argmax's compare, for every point in every
    round after the first), plus the points and mask read once and the
    picks written once;
  * ball query: bytes alone, the points, mask and centers read once and the
    indices and counts written once (exact first-K membership can be found
    without testing every point);
  * scatter (the gather's backward): the gradient rows and their indices
    read once and the output written once;
  * FLOPs: every Linear product at the configuration's shapes, 2 per
    multiply-add; the padding rows of a static shape count, since they
    are computed.

`layers` walks the configuration as the detector builds it: four set
abstraction levels, two feature propagations, voting, the radius bank,
the scale selection and the box head.
"""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet, dense: FLOP/s by the precision of the
# products, and HBM3 bytes/s
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
F32 = 4  # bytes of a float32 or an int32
FPS_OPS_PER_POINT_ROUND = 10


def box_channels(model: dict) -> int:
    """Raw proposal channels: objectness 2, center 3, heading 2 NH, size
    classes and residuals 4 NC, semantics NC."""
    nh, nc = model["num_heading_bins"], model["num_classes"]
    return 2 + 3 + 2 * nh + 5 * nc


def layers(model: dict) -> list[tuple[int, int, int]]:
    """(rows, in, out) of every Linear of one scene's forward."""
    out = []

    def stack(rows, ch, widths):
        for w in widths:
            out.append((rows, ch, w))
            ch = w
        return ch

    ch = 1  # the height feature
    last = []
    for npoint, k, widths in zip(model["sa_npoints"], model["sa_nsamples"],
                                 model["sa_channels"]):
        ch = stack(npoint * k, 3 + ch, widths)
        last.append(ch)
    fp0, fp1 = model["fp_channels"]
    f3 = stack(model["sa_npoints"][2], last[2] + last[3], fp0)
    seed = stack(model["sa_npoints"][1], last[1] + f3, fp1)
    seeds = model["sa_npoints"][1]
    d = model["seed_feat_dim"]
    stack(seeds, seed, (d, d, 3 + seed))  # voting
    P, K = model["num_proposals"], model["cluster_nsample"]
    R = len(model["cluster_radius_bank"])
    feat = 128  # the proposal head's width (models/proposal.py)
    for _ in range(R):
        stack(P * K, 3 + seed, (feat, feat, feat))
    stack(P, R * feat, (feat, R))  # scale selection
    stack(P, feat, (feat, feat, box_channels(model)))
    return out


def forward_flops(model: dict) -> float:
    """Matmul FLOPs of one scene's forward."""
    return float(sum(2 * r * i * o for r, i, o in layers(model)))


def fps_calls(model: dict, B: int, N: int) -> list[dict]:
    """The FPS calls of one forward over B clouds of N points: the four
    set abstractions, then the proposals over the votes."""
    calls, n = [], N
    for m in model["sa_npoints"]:
        calls.append({"B": B, "n": n, "m": m})
        n = m
    calls.append({"B": B, "n": model["sa_npoints"][1],
                  "m": model["num_proposals"]})
    return calls


def ball_query_calls(model: dict, B: int, N: int) -> list[dict]:
    """The ball queries of one forward: each set abstraction's, then one
    over the votes for each radius of the bank."""
    calls, n = [], N
    for m, k in zip(model["sa_npoints"], model["sa_nsamples"]):
        calls.append({"B": B, "n": n, "m": m, "k": k})
        n = m
    for _ in model["cluster_radius_bank"]:
        calls.append({"B": B, "n": model["sa_npoints"][1],
                      "m": model["num_proposals"],
                      "k": model["cluster_nsample"]})
    return calls


def scatter_calls(model: dict, B: int, N: int) -> list[dict]:
    """The gathers whose source needs a gradient in one train step, as
    scatters (u rows of c channels into n): the groupings of SA2-SA4, the
    two 3-NN interpolations, the proposal groupings and the proposal
    centers' gather."""
    sa_np, sa_k = model["sa_npoints"], model["sa_nsamples"]
    sa_out = [w[-1] for w in model["sa_channels"]]
    fp0 = model["fp_channels"][0][-1]
    seed = model["fp_channels"][1][-1]
    calls = [{"B": B, "u": sa_np[i] * sa_k[i], "c": 3 + sa_out[i - 1],
              "n": sa_np[i - 1]} for i in (1, 2, 3)]
    calls.append({"B": B, "u": 3 * sa_np[2], "c": sa_out[3], "n": sa_np[3]})
    calls.append({"B": B, "u": 3 * sa_np[1], "c": fp0, "n": sa_np[2]})
    P, K = model["num_proposals"], model["cluster_nsample"]
    for _ in model["cluster_radius_bank"]:
        calls.append({"B": B, "u": P * K, "c": 3 + seed, "n": sa_np[1]})
    calls.append({"B": B, "u": P, "c": 3, "n": sa_np[1]})
    return calls


def fps_cost(call: dict) -> tuple[float, float]:
    """(fp32 operations, bytes) of one FPS call."""
    B, n, m = call["B"], call["n"], call["m"]
    ops = B * n * (m - 1) * FPS_OPS_PER_POINT_ROUND
    return float(ops), float(B * (n * 3 * F32 + n + m * F32))


def ball_query_cost(call: dict) -> tuple[float, float]:
    B, n, m, k = call["B"], call["n"], call["m"], call["k"]
    read = n * 3 * F32 + n + m * 3 * F32
    return 0.0, float(B * (read + m * k * F32 + m * F32))


def scatter_cost(call: dict) -> tuple[float, float]:
    B, u, c, n = call["B"], call["u"], call["c"], call["n"]
    return 0.0, float(B * (u * c * F32 + u * F32 + n * c * F32))


def bound_seconds(costs, precision: str = "fp32") -> float:
    """The least time the card could take for these (ops, bytes) calls,
    each bound by the larger of its two rooflines."""
    return sum(max(ops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES)
               for ops, nbytes in costs)
