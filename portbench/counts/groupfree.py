"""What Group-Free 3D's work costs by its definition (the Group-Free
cell's rooflines and share of the peak), from the configuration's static
shapes alone, as portbench/counts does for the size-adaptive detector:

  * FLOPs: every Linear of one scene's forward and the attention's two
    products, Q K^T and A V, 2 per multiply-add, at the configuration's
    shapes (padding rows count, since they are computed): the backbone
    (SA1-4 over xyz alone, FP1-2), KPS, the proposal head, the query and
    key projections, and a decoder layer's position embeddings,
    self-attention (the in-projection of the queries, their scores and
    the weighted sum over the candidates, the out-projection),
    cross-attention (the queries' projection, the keys' and values' over
    the seeds, the scores and the sum over the seeds, the
    out-projection), FFN and box head;
  * FPS (B1) and the ball queries: the four set abstractions' calls, each
    costed by portbench/counts's fps_cost and ball_query_cost (KPS picks
    the candidates by a sort, not by FPS);
  * the point count (csrc/box_points.cu): B P N point-box tests of
    BOX_TEST_OPS fp32 operations each (3 differences, 3 absolute values
    and 3 comparisons), or the bytes the function needs: each scene's
    points (3 floats) and mask (1 byte) read once, the boxes' centres and
    sizes read once and the counts written once; the larger of the two
    bounds. The kernel's own re-reads of a scene (once a tile of boxes)
    are its design's, not the function's, and are not counted.
"""

from __future__ import annotations

from portbench.counts import F32

BOX_TEST_OPS = 9


def layers(model: dict) -> list[tuple[int, int, int]]:
    """(rows, in, out) of every product of one scene's forward, Linear or
    attention (an attention product of [r, k] by [k, c] is (r, k, c))."""
    out = []

    def stack(rows, ch, widths):
        for w in widths:
            out.append((rows, ch, w))
            ch = w
        return ch

    ch, last = 0, []
    for npoint, k, widths in zip(model["sa_npoints"], model["sa_nsamples"],
                                 model["sa_channels"]):
        ch = stack(npoint * k, 3 + ch, widths)
        last.append(ch)
    fp0, fp1 = model["fp_channels"]
    f3 = stack(model["sa_npoints"][2], last[2] + last[3], fp0)
    S = model["sa_npoints"][1]
    d = stack(S, last[1] + f3, fp1)
    P, nc = model["groupfree_candidates"], model["num_classes"]
    stack(S, d, (d, d, 1))  # KPS
    head = tuple(model["groupfree_head_channels"])

    def box_head():
        width = stack(P, d, head)
        out.extend([(P, width, 1 + nc), (P, width, 5 + 4 * nc)])

    box_head()
    out.extend([(P, d, d), (S, d, d)])  # the query and key projections
    for _ in range(model["groupfree_layers"]):
        stack(P, 6, (d, d))  # the query position embedding
        stack(S, 3, (d, d))  # the key position embedding
        out.extend([(P, d, 3 * d), (P, d, P), (P, P, d), (P, d, d)])
        out.extend([(P, d, d), (S, d, 2 * d), (P, d, S), (P, S, d),
                    (P, d, d)])
        stack(P, d, (model["groupfree_ffn"], d))
        box_head()
    return out


def forward_flops(model: dict) -> float:
    """Matmul FLOPs of one scene's forward."""
    return float(sum(2 * r * i * o for r, i, o in layers(model)))


def fps_calls(model: dict, B: int, N: int) -> list[dict]:
    """The FPS calls of one forward over B clouds of N points: the four set
    abstractions'."""
    calls, n = [], N
    for m in model["sa_npoints"]:
        calls.append({"B": B, "n": n, "m": m})
        n = m
    return calls


def ball_query_calls(model: dict, B: int, N: int) -> list[dict]:
    """The ball queries of one forward: the four set abstractions'."""
    calls, n = [], N
    for m, k in zip(model["sa_npoints"], model["sa_nsamples"]):
        calls.append({"B": B, "n": n, "m": m, "k": k})
        n = m
    return calls


def box_points_calls(model: dict, B: int, N: int) -> list[dict]:
    """The point count of one parse: every box of the last
    groupfree_stages stages against the scene's N points."""
    return [{"B": B, "n": N,
             "p": model["groupfree_stages"] * model["groupfree_candidates"]}]


def box_points_cost(call: dict) -> tuple[float, float]:
    """(fp32 operations, bytes) of one point count (module docstring)."""
    B, n, p = call["B"], call["n"], call["p"]
    read = B * n * (3 * F32 + 1) + B * p * 6 * F32
    return float(B * p * n * BOX_TEST_OPS), float(read + B * p * F32)
