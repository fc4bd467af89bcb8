"""Host-side preprocessing of a scene in numpy: the range crop and the vote
targets of oriented boxes (the reference's tpu3dsad/utils/native.py:91-135
over cpp/preproc.cpp:88-126). The port does not build the C++ library;
this is its arithmetic, op for op, in float32.
"""

from __future__ import annotations

import numpy as np


def range_crop(points: np.ndarray, lo, hi) -> np.ndarray:
    """points [N,3+] -> int64 indices of the points inside [lo, hi] (both
    ends included), compared in float32."""
    pts = np.asarray(points[:, :3], np.float32)
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    return np.nonzero(np.all((pts >= lo) & (pts <= hi), axis=-1))[0]


def vote_targets(points: np.ndarray, boxes: np.ndarray):
    """points [N,3], boxes [G,8] (cx cy cz dx dy dz heading cls) ->
    (votes [N,3] float32 = center - point, mask [N] bool).

    A point belongs to a box when its box-frame coordinates lie within the
    half extents + 1e-6 on every axis; a point in several boxes takes the
    last one. As cpp/preproc.cpp computes it (built with
    -ffp-contract=off): every product and sum is one rounded float32
    operation, lx = c*px + s*py and ly = -s*px + c*py with
    (px, py, pz) = point - center. cos and sin are taken in float64 and
    rounded to float32."""
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    bx = np.ascontiguousarray(boxes, np.float32).reshape(-1, 8)
    votes = np.zeros((pts.shape[0], 3), np.float32)
    vmask = np.zeros(pts.shape[0], bool)
    eps = np.float32(1e-6)
    for box in bx:
        center = box[:3]
        half = box[3:6] * np.float32(0.5)
        c = np.float32(np.cos(np.float64(box[6])))
        s = np.float32(np.sin(np.float64(box[6])))
        p = pts - center
        lx = c * p[:, 0] + s * p[:, 1]
        ly = -s * p[:, 0] + c * p[:, 1]
        inside = ((np.abs(lx) <= half[0] + eps)
                  & (np.abs(ly) <= half[1] + eps)
                  & (np.abs(p[:, 2]) <= half[2] + eps))
        votes[inside] = center - pts[inside]
        vmask |= inside
    return votes, vmask
