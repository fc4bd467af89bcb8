"""Training scenes for the training cells: a frozen copy of
tpu3dsad_torch/data/synthetic.py::detection_scene / detection_batch and of
data/pipeline.py's scene_to_training_dict, candidate_votes and pad_boxes
(numpy, seeded), kept here so that no later change to the program moves
the yardstick.

A 4 m room with 3-8 oriented boxes on the floor; a quarter of the points
on the floor, the rest on the boxes' surfaces, in a random point order;
vote targets point from each object point to its box's center, with up to
V candidates where boxes overlap.
"""

from __future__ import annotations

import numpy as np


def class_mean_sizes(num_classes: int) -> np.ndarray:
    """Size priors [NC, 3] (config.py::class_mean_sizes)."""
    base = np.array(
        [
            [0.6, 0.6, 0.9],
            [1.6, 0.9, 0.75],
            [2.0, 1.0, 0.9],
            [0.5, 0.5, 1.6],
            [1.0, 2.0, 0.6],
            [0.4, 0.4, 0.5],
        ],
        np.float32,
    )
    reps = int(np.ceil(num_classes / len(base)))
    scaled = np.concatenate([base * (1 + 0.3 * r) for r in range(reps)])
    return scaled[:num_classes]


def _cube_surface(n: int, rng: np.random.Generator) -> np.ndarray:
    rng.random((n,))  # make_shape draws u and v for every kind
    rng.random((n,))
    pts = rng.uniform(-1, 1, (n, 3))
    ax = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    pts[np.arange(n), ax] = sign
    return pts.astype(np.float32)


def detection_scene(rng: np.random.Generator, num_points: int,
                    num_classes: int, max_objects: int = 8,
                    room: float = 4.0, min_objects: int = 3):
    """(points [N,3], (centers, sizes, headings, classes), owner [N])."""
    g = int(rng.integers(min_objects, max_objects + 1))
    classes = rng.integers(0, num_classes, g)
    sizes = class_mean_sizes(num_classes)[classes] * rng.uniform(
        0.8, 1.25, (g, 3))
    headings = rng.uniform(-np.pi, np.pi, g)
    centers = np.stack(
        [
            rng.uniform(-room / 2 + 1, room / 2 - 1, g),
            rng.uniform(-room / 2 + 1, room / 2 - 1, g),
            sizes[:, 2] / 2,
        ],
        -1,
    )
    n_floor = num_points // 4
    n_obj_total = num_points - n_floor
    per = np.full(g, n_obj_total // g)
    per[: n_obj_total - per.sum()] += 1

    pts = [np.stack(
        [
            rng.uniform(-room / 2, room / 2, n_floor),
            rng.uniform(-room / 2, room / 2, n_floor),
            0.01 * rng.standard_normal(n_floor),
        ],
        -1,
    )]
    owner = [np.full(n_floor, -1)]
    for i in range(g):
        cube = _cube_surface(per[i], rng) * 0.5
        cube *= sizes[i]
        c, s = np.cos(headings[i]), np.sin(headings[i])
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        pts.append(cube @ rot.T + centers[i])
        owner.append(np.full(per[i], i))
    points = np.concatenate(pts).astype(np.float32)
    owner = np.concatenate(owner).astype(np.int32)
    perm = rng.permutation(num_points)
    spec = (centers.astype(np.float32), sizes.astype(np.float32),
            headings.astype(np.float32), classes.astype(np.int32))
    return points[perm], spec, owner[perm]


def _pad_boxes(arr: np.ndarray, max_boxes: int):
    g = min(arr.shape[0], max_boxes)
    out = np.zeros((max_boxes,) + arr.shape[1:], arr.dtype)
    out[:g] = arr[:g]
    mask = np.zeros(max_boxes, bool)
    mask[:g] = True
    return out, mask


def _candidate_votes(points, votes, vmask, owner, centers, sizes, headings,
                     V: int):
    """[N,3] primary offsets -> [N,V,3]: slots 1..V-1 take the other boxes
    that contain the point (oriented, box-index order); unused slots copy
    the primary."""
    out = np.repeat(votes[:, None, :], V, axis=1)
    if V <= 1 or not len(centers) or not vmask.any():
        return out
    vp = np.nonzero(vmask)[0]
    p = points[vp]
    rx = p[:, 0:1] - centers[None, :, 0]
    ry = p[:, 1:2] - centers[None, :, 1]
    rz = p[:, 2:3] - centers[None, :, 2]
    ch, sh = np.cos(headings)[None, :], np.sin(headings)[None, :]
    half = sizes / 2 + 1e-6
    inside = (
        (np.abs(ch * rx + sh * ry) <= half[None, :, 0])
        & (np.abs(-sh * rx + ch * ry) <= half[None, :, 1])
        & (np.abs(rz) <= half[None, :, 2])
    )
    inside[np.arange(len(vp)), owner[vp]] = False
    rows = np.nonzero(inside.any(axis=1))[0]
    if not len(rows):
        return out
    ins = inside[rows]
    order = np.argsort(~ins, axis=1, kind="stable")[:, : V - 1]
    kslots = order.shape[1]
    valid_c = np.take_along_axis(ins, order, axis=1)
    off = centers[order] - p[rows][:, None, :]
    sel = vp[rows]
    out[sel, 1: 1 + kslots] = np.where(valid_c[..., None], off,
                                       out[sel, :1])
    return out


def training_scene(rng: np.random.Generator, num_points: int, budget: int,
                   num_classes: int, max_boxes: int,
                   vote_candidates: int) -> dict:
    """One padded training example: a scene of num_points points padded
    with masked zero rows to `budget`, its vote targets [budget, V, 3] (or
    [budget, 3] where V = 1) and its boxes padded to max_boxes."""
    points, (centers, sizes, headings, classes), owner = detection_scene(
        rng, num_points, num_classes)
    votes = np.zeros((num_points, 3), np.float32)
    vmask = owner >= 0
    votes[vmask] = centers[owner[vmask]] - points[vmask]
    if vote_candidates > 1:
        votes = _candidate_votes(points, votes, vmask, owner, centers,
                                 sizes, headings, vote_candidates)
    pad = budget - num_points

    def rows(a, fill=0):
        return np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, a.dtype)])

    item = {
        "points": rows(points),
        "point_mask": rows(np.ones(num_points, bool), False),
        "vote_targets": rows(votes.astype(np.float32)),
        "vote_mask": rows(vmask, False),
    }
    for key, arr, dtype in (("gt_centers", centers, np.float32),
                            ("gt_sizes", sizes, np.float32),
                            ("gt_headings", headings, np.float32),
                            ("gt_classes", classes, np.int32)):
        item[key], item["gt_mask"] = _pad_boxes(arr.astype(dtype), max_boxes)
    return item


def training_batches(rng: np.random.Generator, count: int, batch: int,
                     **scene) -> dict:
    """`count` x `batch` training scenes stacked [count, batch, ...]."""
    items = [training_scene(rng, **scene) for _ in range(count * batch)]
    return {k: np.stack([it[k] for it in items]).reshape(
        (count, batch) + items[0][k].shape) for k in items[0]}


def train_pool(rng: np.random.Generator, w: dict, config: dict):
    """A training cell's pool [pool_steps, batch, ...] and the seed of its
    augmentation generator."""
    pool = training_batches(
        rng, w["pool_steps"], w["batch"], num_points=w["points"],
        budget=w["budget"], num_classes=config["model"]["num_classes"],
        max_boxes=config["data"]["max_boxes"],
        vote_candidates=config["data"]["vote_candidates"])
    return pool, int(rng.integers(1 << 62))
