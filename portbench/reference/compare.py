"""The comparisons that decide `correct`.

Serving: each served slot (a scene's proposal) agrees with the reference
when its class and keep flag are equal and its center, size, heading and
objectness lie within TOL of the reference's; the number compared is the
share of slots that do not agree, in percent. The tolerances are some
hundred float32 roundings of the values they compare (meters and radians
of a few units, probabilities below 1).

Training: the relative gap of the first step's loss; the worst leaf's gap
between the norms of the first gradient; and the median leaf's gap
between the norms of the parameters' change over the checked steps; the
norm gaps each against the reference's norm of that leaf or of the median
leaf, whichever is larger. The later steps' losses and the worst leaf's
change are not compared: float32 summation order alone (the reference
against itself, its scatter's atomics in another order) moves them by 3-16%
and 8-9%, as far as the program moves them (PERF.md §2).
"""

from __future__ import annotations

import numpy as np

TOL = {"center": 1e-4, "size": 1e-4, "heading": 1e-4, "obj_prob": 1e-5}
EXACT = ("sem_cls", "keep")


def slot_mismatches(prog: dict, ref: dict) -> tuple[int, int]:
    """(slots that disagree, slots) of one batch's six fields [B, P, ...],
    as numpy arrays or tensors on the host."""
    prog = {k: np.asarray(v) for k, v in prog.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    bad = np.zeros(ref["keep"].shape, bool)
    for k, tol in TOL.items():
        gap = np.abs(prog[k].astype(np.float64) - ref[k].astype(np.float64))
        if gap.ndim > bad.ndim:
            gap = gap.max(-1)
        bad |= ~(gap <= tol)
    for k in EXACT:
        bad |= prog[k].astype(np.int64) != ref[k].astype(np.int64)
    return int(bad.sum()), int(bad.size)


def detections(fields: dict) -> list:
    """Scene 0's kept boxes, in slot order, as the serving CLI lists them:
    {"center", "size", "heading", "score", "class"} each."""
    f = {k: np.asarray(v) for k, v in fields.items()}
    keep = f["keep"][0].astype(bool)
    return [{"center": f["center"][0][i].tolist(),
             "size": f["size"][0][i].tolist(),
             "heading": float(f["heading"][0][i]),
             "score": float(f["obj_prob"][0][i]),
             "class": int(f["sem_cls"][0][i])}
            for i in np.nonzero(keep)[0]]


def box_mismatches(prog: list, ref: list) -> tuple[int, int]:
    """(boxes that disagree, boxes) between two detection lists: boxes at
    the same place in both lists are held to TOL, and each box one list
    has past the other's end disagrees."""
    tol = {"center": TOL["center"], "size": TOL["size"],
           "heading": TOL["heading"], "score": TOL["obj_prob"]}
    bad = abs(len(prog) - len(ref))
    for p, r in zip(prog, ref):
        ok = p["class"] == r["class"] and all(
            np.max(np.abs(np.asarray(p[k], np.float64)
                          - np.asarray(r[k], np.float64))) <= t
            for k, t in tol.items())
        bad += not ok
    return bad, max(len(prog), len(ref))


def share(counts: list) -> float:
    """Percent of the summed (bad, total) pairs that are bad; NaN, which
    no limit passes, where nothing was compared."""
    bad = sum(b for b, _ in counts)
    total = sum(t for _, t in counts)
    return 100.0 * bad / total if total else float("nan")


def _gaps(prog: dict, ref: dict) -> list:
    med = float(np.median(list(ref.values())))
    return [abs(prog[n] - ref[n]) / max(ref[n], med) for n in ref]


def train_gaps(prog: dict, ref: dict) -> dict:
    """{"first_loss_gap", "first_grad_gap", "median_change_gap"} of the
    program's first steps against the reference's (each a dict of "loss"
    [steps], "grad1" {leaf: norm}, "change" {leaf: norm})."""
    return {
        "first_loss_gap": abs(prog["loss"][0] - ref["loss"][0])
        / abs(ref["loss"][0]),
        "first_grad_gap": max(_gaps(prog["grad1"], ref["grad1"])),
        "median_change_gap": float(np.median(_gaps(prog["change"],
                                                   ref["change"]))),
    }
