"""Synthetic point clouds on the host, in numpy (tpu3dsad/data/synthetic.py):
for one generator state they draw exactly what the reference does.

* classification: parametric shapes (sphere, cube, cylinder, cone, torus,
  plane) with noise;
* detection: indoor-style scenes, a floor plane and a few boxes on it
  with analytic centers, sizes and headings and per-point ownership, so
  vote targets and AP have closed-form expected values. The synthetic
  dataset's host train and val batches (registry.py) are these; training
  on the card makes its own (device_pipeline.synthetic_detection_batch).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpu3dsad_torch.config import class_mean_sizes
from tpu3dsad_torch.data.pipeline import scene_to_training_dict

SHAPE_NAMES = ("sphere", "cube", "cylinder", "cone", "torus", "plane")


def make_shape(kind: str, n: int, rng: np.random.Generator) -> np.ndarray:
    u = rng.random((n,))
    v = rng.random((n,))
    if kind == "sphere":
        theta, phi = 2 * np.pi * u, np.arccos(2 * v - 1)
        pts = np.stack(
            [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], -1
        )
    elif kind == "cube":
        pts = rng.uniform(-1, 1, (n, 3))
        ax = rng.integers(0, 3, n)
        sign = rng.choice([-1.0, 1.0], n)
        pts[np.arange(n), ax] = sign
    elif kind == "cylinder":
        theta = 2 * np.pi * u
        pts = np.stack([np.cos(theta), np.sin(theta), 2 * v - 1], -1)
    elif kind == "cone":
        theta = 2 * np.pi * u
        r = 1 - v
        pts = np.stack([r * np.cos(theta), r * np.sin(theta), 2 * v - 1], -1)
    elif kind == "torus":
        theta, phi = 2 * np.pi * u, 2 * np.pi * v
        r_t, r_c = 1.0, 0.35
        pts = np.stack(
            [
                (r_t + r_c * np.cos(phi)) * np.cos(theta),
                (r_t + r_c * np.cos(phi)) * np.sin(theta),
                r_c * np.sin(phi),
            ],
            -1,
        )
    elif kind == "plane":
        pts = np.stack([2 * u - 1, 2 * v - 1, np.zeros(n)], -1)
    else:
        raise ValueError(kind)
    return pts.astype(np.float32)


def classification_batch(
    rng: np.random.Generator,
    batch_size: int,
    num_points: int,
    num_classes: int = len(SHAPE_NAMES),
    noise: float = 0.02,
):
    """-> dict(points [B,N,3], labels [B], mask [B,N])."""
    labels = rng.integers(0, num_classes, batch_size)
    pts = np.stack(
        [
            make_shape(SHAPE_NAMES[l % len(SHAPE_NAMES)], num_points, rng)
            for l in labels
        ]
    )
    pts += noise * rng.standard_normal(pts.shape).astype(np.float32)
    scale = rng.uniform(0.8, 1.2, (batch_size, 1, 1)).astype(np.float32)
    return {
        "points": (pts * scale).astype(np.float32),
        "labels": labels.astype(np.int32),
        "mask": np.ones((batch_size, num_points), bool),
    }


@dataclass
class SceneSpec:
    """Ground truth of one synthetic detection scene."""

    centers: np.ndarray  # [G, 3]
    sizes: np.ndarray  # [G, 3]
    headings: np.ndarray  # [G]
    classes: np.ndarray  # [G] int

    @property
    def num_objects(self):
        return len(self.centers)


def detection_scene(
    rng: np.random.Generator,
    num_points: int,
    num_classes: int = 4,
    max_objects: int = 8,
    room: float = 4.0,
    min_objects: int = 3,
):
    """One synthetic indoor scene.

    Returns (points [N,3], spec, point_instance [N] int — -1 for floor,
    else object index). Object points are drawn on box surfaces so centers
    are analytic; classes map to distinct size priors ("chair" small,
    "table" flat, ...).
    """
    g = int(rng.integers(min_objects, max_objects + 1))
    # per-class mean sizes (l, w, h) — priors for the size-adaptive bank
    mean_sizes = class_mean_sizes(num_classes)
    classes = rng.integers(0, num_classes, g)
    sizes = mean_sizes[classes] * rng.uniform(0.8, 1.25, (g, 3))
    headings = rng.uniform(-np.pi, np.pi, g)
    centers = np.stack(
        [
            rng.uniform(-room / 2 + 1, room / 2 - 1, g),
            rng.uniform(-room / 2 + 1, room / 2 - 1, g),
            sizes[:, 2] / 2,  # sitting on the floor
        ],
        -1,
    )

    n_floor = num_points // 4
    n_obj_total = num_points - n_floor
    per = np.full(g, n_obj_total // g)
    per[: n_obj_total - per.sum()] += 1

    pts, owner = [], []
    floor = np.stack(
        [
            rng.uniform(-room / 2, room / 2, n_floor),
            rng.uniform(-room / 2, room / 2, n_floor),
            0.01 * rng.standard_normal(n_floor),
        ],
        -1,
    )
    pts.append(floor)
    owner.append(np.full(n_floor, -1))
    for i in range(g):
        cube = make_shape("cube", per[i], rng) * 0.5  # unit surface box
        cube *= sizes[i]
        c, s = np.cos(headings[i]), np.sin(headings[i])
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        pts.append(cube @ rot.T + centers[i])
        owner.append(np.full(per[i], i))

    points = np.concatenate(pts).astype(np.float32)
    owner = np.concatenate(owner).astype(np.int32)
    perm = rng.permutation(num_points)
    spec = SceneSpec(
        centers.astype(np.float32),
        sizes.astype(np.float32),
        headings.astype(np.float32),
        classes.astype(np.int32),
    )
    return points[perm], spec, owner[perm]


def detection_batch(
    rng: np.random.Generator,
    batch_size: int,
    num_points: int,
    num_classes: int = 4,
    max_boxes: int = 64,
    vote_candidates: int = 1,
):
    """Padded detection batch with vote targets (see losses.py for the
    target convention; vote_candidates>1 → [N,V,3] GT_VOTE_FACTOR)."""
    items = []
    for _ in range(batch_size):
        points, spec, owner = detection_scene(rng, num_points, num_classes)
        items.append(scene_to_training_dict(points, spec, owner, max_boxes,
                                            vote_candidates=vote_candidates))
    return {k: np.stack([it[k] for it in items]) for k in items[0]}
