"""SUN RGB-D detection dataset, benchmark config #2 (20k points, 10
classes; tpu3dsad/data/sunrgbd.py). For one generator state it draws and
computes exactly what the reference does.

On-disk contract (the extracted layout), under `<root>/<split>/`:

  <idx>_pc.npy    float32 [N, 6]   xyz + rgb(0-1) (upright depth, Z-up)
  <idx>_bbox.npy  float32 [G, 8]   cx cy cz dx dy dz heading cls
                                   (dx/dy/dz FULL extents; cls in 0..9)
  <idx>_votes.npy float32 [N, 4]   optional precomputed votes (mask, dx,
                  or [N, 10]       dy, dz), or the lineage layout of mask +
                                   3 candidate offsets (`lineage_votes`):
                                   used as they are when augmentation is
                                   off; otherwise the votes are recomputed
                                   from the augmented boxes

10 classes, oriented boxes with a heading about +Z. Computed votes take
the C++ library's float32 arithmetic (data/host.py::vote_targets).
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from tpu3dsad_torch.data import host
from tpu3dsad_torch.data.augment import augment_scene, resolve_aug, rot_z
from tpu3dsad_torch.data.pipeline import (
    candidate_votes,
    compact_owner,
    iter_val_batches,
    pad_boxes,
    recover_owner,
)

SUNRGBD_CLASS_NAMES = (
    "bed", "table", "sofa", "chair", "toilet", "desk", "dresser",
    "night_stand", "bookshelf", "bathtub",
)

# the lineage's mean_size_arr priors
SUNRGBD_MEAN_SIZES = np.array(
    [
        [2.114256, 1.620300, 0.927272], [0.791118, 1.279516, 0.718182],
        [0.923508, 1.867419, 0.845495], [0.591958, 0.552978, 0.827272],
        [0.699104, 0.454178, 0.756250], [0.69519, 1.346299, 0.736364],
        [0.528526, 1.002642, 1.172878], [0.500618, 0.632163, 0.683424],
        [0.404671, 1.071108, 1.688889], [0.76584, 1.398258, 0.472728],
    ],
    np.float32,
)
GT_VOTE_FACTOR = 3  # the lineage's candidate count in <idx>_votes.npy


def points_in_oriented_box(points, center, size, heading):
    """Bool mask of the points inside an oriented (Z-up) box."""
    local = (points - center) @ rot_z(heading)  # world -> box: R^T, @ R
    half = size / 2
    return np.all(np.abs(local) <= half + 1e-6, axis=-1)


def lineage_votes(points: np.ndarray, bbox: np.ndarray) -> np.ndarray:
    """The [N, 10] votes layout: mask + GT_VOTE_FACTOR candidate offsets.
    A point inside several boxes carries up to 3 centers; unfilled slots
    repeat the first. As in the lineage, whose slot index is clamped at 2,
    a 4th and later containing box overwrites slot 3."""
    n = len(points)
    votes = np.zeros((n, 10), np.float32)
    filled = np.zeros(n, np.int64)
    for row in bbox:
        inside = points_in_oriented_box(points, row[:3], row[3:6], row[6])
        if not inside.any():
            continue
        offset = row[:3] - points[inside]
        slot = np.minimum(filled[inside], GT_VOTE_FACTOR - 1)
        votes[inside, 0] = 1.0
        flat = np.nonzero(inside)[0]
        for s in range(GT_VOTE_FACTOR):
            at = slot == s
            votes[flat[at], 1 + 3 * s : 4 + 3 * s] = offset[at]
        filled[inside] = np.minimum(filled[inside] + 1, GT_VOTE_FACTOR)
    # candidate 0 into the empty slots (never an all-zero candidate)
    one = filled == 1
    votes[one, 4:7] = votes[one, 7:10] = votes[one, 1:4]
    two = filled == 2
    votes[two, 7:10] = votes[two, 1:4]
    return votes


class SunRGBDDetectionDataset:
    num_classes = len(SUNRGBD_CLASS_NAMES)
    class_names = SUNRGBD_CLASS_NAMES
    mean_sizes = SUNRGBD_MEAN_SIZES

    def __init__(self, cfg):
        self.cfg = cfg
        self.root = cfg.data.root
        if not self.root or not os.path.isdir(self.root):
            raise FileNotFoundError(
                f"data.root={self.root!r} not found — point it at the "
                "extracted SUN RGB-D .npy directory (see module docstring)")
        self.train_items = self._items("train")
        self.val_items = self._items("val")

    def _items(self, split):
        d = os.path.join(self.root, split)
        idxs = sorted(os.path.basename(p)[: -len("_pc.npy")]
                      for p in glob(os.path.join(d, "*_pc.npy")))
        return [(d, i) for i in idxs]

    def steps_per_epoch(self, batch_size: int) -> int:
        return max(1, len(self.train_items) // batch_size)

    def _load_scene(self, d, idx, rng, augment):
        pc = np.load(os.path.join(d, f"{idx}_pc.npy"))
        bboxes = np.load(os.path.join(d, f"{idx}_bbox.npy")).reshape(-1, 8)
        centers = bboxes[:, :3].astype(np.float32)
        sizes = bboxes[:, 3:6].astype(np.float32)
        headings = bboxes[:, 6].astype(np.float32)
        classes = bboxes[:, 7].astype(np.int32)

        n_budget = self.cfg.data.num_points
        n = pc.shape[0]
        sel = (rng.choice(n, n_budget, replace=n < n_budget)
               if n != n_budget else np.arange(n))
        points = pc[sel, :3].astype(np.float32)
        colors = None
        if self.cfg.data.use_color:
            # colour-less scenes get zeros, so every item of a batch has
            # the same keys
            colors = (pc[sel, 3:6].astype(np.float32) if pc.shape[1] >= 6
                      else np.zeros((len(sel), 3), np.float32))

        augmented = augment and self.cfg.data.augment
        if augmented:
            points, centers, headings, sizes = augment_scene(
                rng, points, centers, headings, sizes,
                **resolve_aug(self.cfg.data, "sunrgbd"))

        V = max(1, self.cfg.data.vote_candidates)
        compact = self.cfg.data.compact_votes
        votes = np.zeros((n_budget, 3), np.float32)
        vmask = np.zeros(n_budget, bool)
        votes_file = os.path.join(d, f"{idx}_votes.npy")
        if compact and os.path.exists(votes_file):
            raise ValueError(
                "data.compact_votes cannot represent the verbatim offsets "
                f"of {votes_file} (owners are only exact for votes aimed at "
                "box centers) — use expanded votes for this dataset")
        if not augmented and os.path.exists(votes_file):
            # [N,4] (mask, dxyz) or the lineage [N,10] layout
            pre = np.load(votes_file)[sel]
            vmask = pre[:, 0] > 0.5
            if pre.shape[1] >= 10:
                cand = pre[:, 1:10].astype(np.float32).reshape(n_budget, 3, 3)
                votes = cand[:, 0]
                if V > 1:
                    full = np.repeat(votes[:, None, :], V, axis=1)
                    full[:, 1 : min(V, 3)] = cand[:, 1 : min(V, 3)]
                    votes = full
            else:
                votes = pre[:, 1:4].astype(np.float32)
                if V > 1:
                    votes = self._expand_candidates(
                        points, votes, vmask, centers, sizes, headings, V)
        elif len(centers):
            boxes8 = np.concatenate(
                [centers, sizes, headings[:, None],
                 classes[:, None].astype(np.float32)], axis=1)
            votes, vmask = host.vote_targets(points, boxes8)
            if V > 1 and not compact:
                votes = self._expand_candidates(
                    points, votes, vmask, centers, sizes, headings, V)
        elif V > 1 and not compact:
            # a scene without boxes keeps the [N,V,3] shape
            votes = np.repeat(votes[:, None, :], V, axis=1)

        max_boxes = self.cfg.data.max_boxes
        c, bm = pad_boxes(centers, max_boxes)
        s, _ = pad_boxes(sizes, max_boxes)
        h, _ = pad_boxes(headings, max_boxes)
        k, _ = pad_boxes(classes, max_boxes)
        out_extra = {} if colors is None else {"point_features": colors}
        if compact:
            # exact here: every computed vote aims at its box's center
            owner = recover_owner(points, votes, vmask, centers)
            vote_fields = {"vote_owner": compact_owner(owner, max_boxes)}
        else:
            vote_fields = {"vote_targets": votes, "vote_mask": vmask}
        return {
            **out_extra,
            "points": points,
            "point_mask": np.ones(n_budget, bool),
            **vote_fields,
            "gt_centers": c,
            "gt_sizes": s,
            "gt_headings": h,
            "gt_classes": k,
            "gt_mask": bm,
        }

    @staticmethod
    def _expand_candidates(points, votes, vmask, centers, sizes, headings, V):
        """[N,3] -> [N,V,3] by candidate_votes, the primary owner being the
        box whose center the vote points at (exact for computed votes; the
        nearest center for votes from a file)."""
        owner = recover_owner(points, votes, vmask, centers)
        return candidate_votes(points, votes, vmask, owner, centers, sizes,
                               headings, V)

    def _batch(self, items, rng, batch_size, augment):
        picks = rng.choice(len(items), batch_size,
                           replace=len(items) < batch_size)
        out = [self._load_scene(*items[p], rng, augment) for p in picks]
        return {k: np.stack([it[k] for it in out]) for k in out[0]}

    def train_batch(self, rng, batch_size):
        return self._batch(self.train_items, rng, batch_size, augment=True)

    def val_batches(self, rng, batch_size):
        items = self.val_items or self.train_items
        yield from iter_val_batches(
            items, lambda it: self._load_scene(*it, rng, False), batch_size)
