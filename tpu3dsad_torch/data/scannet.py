"""ScanNet V2 detection dataset, benchmark config #3 (40k points, 18
classes; tpu3dsad/data/scannet.py). For one generator state it draws and
computes exactly what the reference does.

On-disk contract (the extracted .npy layout), under `<root>/<split>/`:

  <scan>_vert.npy       float32 [N, 6]  xyz + rgb(0-255)
  <scan>_ins_label.npy  int     [N]     instance id (0 = unannotated)
  <scan>_sem_label.npy  int     [N]     nyu40 semantic id
  <scan>_bbox.npy       float32 [G, 7]  cx cy cz dx dy dz nyu40_cls
                                        (axis-aligned: no heading)

The scene list is the sorted <scan> prefixes. Per scene: subsample to the
point budget, colour as rgb/256 (data.use_color), host augmentation
(data.augment), then the vote targets: every point of an annotated
instance of a benchmark class votes for the center of the box nearest the
instance's median, with V = data.vote_candidates candidates
(pipeline.candidate_votes) or, under data.compact_votes, as int8 owners
that the train step expands.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from tpu3dsad_torch.data.augment import augment_scene, resolve_aug
from tpu3dsad_torch.data.pipeline import (
    candidate_votes,
    compact_owner,
    iter_val_batches,
    pad_boxes,
)

# the 18 ScanNet benchmark classes and their nyu40 ids
SCANNET_CLASS_NAMES = (
    "cabinet", "bed", "chair", "sofa", "table", "door", "window",
    "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
    "showercurtain", "toilet", "sink", "bathtub", "garbagebin",
)
NYU40_IDS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)

# per-class mean box sizes (meters), the lineage's priors
SCANNET_MEAN_SIZES = np.array(
    [
        [0.775, 0.949, 0.966], [1.876, 1.842, 1.193], [0.612, 0.620, 0.704],
        [1.442, 1.605, 0.837], [1.160, 1.055, 0.500], [0.620, 0.726, 2.023],
        [0.288, 1.160, 1.384], [0.404, 1.074, 1.688], [0.596, 0.551, 0.850],
        [0.388, 0.600, 0.728], [0.696, 1.347, 0.500], [0.555, 1.006, 1.883],
        [0.972, 1.557, 0.948], [0.582, 1.163, 1.815], [0.406, 0.506, 0.504],
        [0.489, 0.632, 0.602], [0.868, 1.270, 1.334], [0.261, 0.283, 0.543],
    ],
    np.float32,
)


class ScanNetDetectionDataset:
    num_classes = len(SCANNET_CLASS_NAMES)
    class_names = SCANNET_CLASS_NAMES
    mean_sizes = SCANNET_MEAN_SIZES

    def __init__(self, cfg):
        self.cfg = cfg
        self.root = cfg.data.root
        if not self.root or not os.path.isdir(self.root):
            raise FileNotFoundError(
                f"data.root={self.root!r} not found — point it at the "
                "extracted ScanNet .npy directory (see module docstring)")
        self.nyu40_to_cls = {n: i for i, n in enumerate(NYU40_IDS)}
        self.train_scans = self._scan_list("train")
        self.val_scans = self._scan_list("val")

    def _scan_list(self, split):
        d = os.path.join(self.root, split)
        scans = sorted(os.path.basename(p)[: -len("_vert.npy")]
                       for p in glob(os.path.join(d, "*_vert.npy")))
        return [(d, s) for s in scans]

    def steps_per_epoch(self, batch_size: int) -> int:
        return max(1, len(self.train_scans) // batch_size)

    def _load_scene(self, d, scan, rng, augment):
        verts = np.load(os.path.join(d, f"{scan}_vert.npy"))
        ins = np.load(os.path.join(d, f"{scan}_ins_label.npy"))
        sem = np.load(os.path.join(d, f"{scan}_sem_label.npy"))
        bboxes = np.load(os.path.join(d, f"{scan}_bbox.npy"))

        keep = np.array(
            [self.nyu40_to_cls.get(int(b[6]), -1) >= 0 for b in bboxes], bool
        ) if len(bboxes) else np.zeros(0, bool)
        bboxes = bboxes[keep]
        centers = bboxes[:, :3].astype(np.float32)
        sizes = bboxes[:, 3:6].astype(np.float32)
        headings = np.zeros(len(bboxes), np.float32)  # axis-aligned
        classes = np.array([self.nyu40_to_cls[int(b[6])] for b in bboxes],
                           np.int32)

        n_budget = self.cfg.data.num_points
        n = verts.shape[0]
        sel = (rng.choice(n, n_budget, replace=n < n_budget)
               if n != n_budget else np.arange(n))
        points = verts[sel, :3].astype(np.float32)
        colors = None
        if self.cfg.data.use_color:
            # colour-less scenes get zeros, so every item of a batch has
            # the same keys
            colors = ((verts[sel, 3:6] / 256.0).astype(np.float32)
                      if verts.shape[1] >= 6
                      else np.zeros((len(sel), 3), np.float32))
        ins = ins[sel]
        sem = sem[sel]

        if augment and self.cfg.data.augment:
            points, centers, headings, sizes = augment_scene(
                rng, points, centers, headings, sizes,
                **resolve_aug(self.cfg.data, "scannet"))

        # the points of an annotated instance of a benchmark class vote for
        # the center of the box nearest the instance's median
        V = max(1, self.cfg.data.vote_candidates)
        votes = np.zeros((n_budget, 3), np.float32)
        vmask = np.zeros(n_budget, bool)
        owner = np.full(n_budget, -1, np.int64)  # the primary box a point
        if len(centers):
            for i in np.unique(ins):
                if i == 0:
                    continue
                pt_idx = np.nonzero(ins == i)[0]
                if not len(pt_idx):
                    continue
                if self.nyu40_to_cls.get(int(np.median(sem[pt_idx])), -1) < 0:
                    continue
                med = np.median(points[pt_idx], axis=0)
                b = int(np.argmin(np.sum((centers - med) ** 2, -1)))
                votes[pt_idx] = centers[b] - points[pt_idx]
                vmask[pt_idx] = True
                owner[pt_idx] = b
        if V > 1 and not self.cfg.data.compact_votes:
            # a deliberate deviation from the lineage, which tiles V equal
            # copies of the primary vote (the same as V = 1 under the
            # min-over-V loss): slots 1..V-1 take other containing boxes
            votes = candidate_votes(points, votes, vmask, owner, centers,
                                    sizes, headings, V)

        max_boxes = self.cfg.data.max_boxes
        c, bm = pad_boxes(centers, max_boxes)
        s, _ = pad_boxes(sizes, max_boxes)
        h, _ = pad_boxes(headings, max_boxes)
        k, _ = pad_boxes(classes, max_boxes)
        out_extra = {} if colors is None else {"point_features": colors}
        if self.cfg.data.compact_votes:
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

    def _batch(self, scans, rng, batch_size, augment):
        picks = rng.choice(len(scans), batch_size,
                           replace=len(scans) < batch_size)
        items = [self._load_scene(*scans[p], rng, augment) for p in picks]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def train_batch(self, rng, batch_size):
        return self._batch(self.train_scans, rng, batch_size, augment=True)

    def val_batches(self, rng, batch_size):
        scans = self.val_scans or self.train_scans
        yield from iter_val_batches(
            scans, lambda it: self._load_scene(*it, rng, False), batch_size)
