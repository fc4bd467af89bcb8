"""ModelNet40-style classification dataset, config #1's data
(tpu3dsad/data/modelnet.py; for one seed its batches are bitwise the
reference's). On-disk contract under `<root>/<split>/`
(data/preproc_modelnet.py writes it):

  <name>_pts.npy   float32 [N, 3+]   points (xyz first; extra columns kept)
  <name>_label.npy int    scalar/[1] class id

Clouds are normalised to the unit sphere, subsampled (or repeated) to the
point budget, and on train batches augmented by a rotation about +z, a
scale and a clipped point jitter (the pointnet2 classification recipe).
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np


class ModelNetClassificationDataset:
    """Train batches drawn with replacement where a split has fewer items
    than a batch; val batches through iter_val_batches (every item once,
    the tail padded under scene_mask). num_classes = the largest train
    label + 1."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.root = cfg.data.root
        if not self.root or not os.path.isdir(self.root):
            raise FileNotFoundError(
                f"data.root={self.root!r} not found — point it at the "
                "extracted ModelNet .npy directory (see module docstring)"
            )
        self.train_items = self._items("train")
        self.val_items = self._items("val") or self._items("test")
        labels = [self._label(*it) for it in self.train_items]
        self.num_classes = int(max(labels)) + 1 if labels else 0

    def _items(self, split):
        d = os.path.join(self.root, split)
        names = sorted(
            os.path.basename(p)[: -len("_pts.npy")]
            for p in glob(os.path.join(d, "*_pts.npy"))
        )
        return [(d, n) for n in names]

    def _label(self, d, name):
        return int(np.asarray(np.load(os.path.join(d, f"{name}_label.npy"))).reshape(()))

    def steps_per_epoch(self, batch_size: int) -> int:
        return max(1, len(self.train_items) // batch_size)

    def _load(self, d, name, rng, augment):
        pts = np.load(os.path.join(d, f"{name}_pts.npy"))[:, :3].astype(np.float32)
        # unit-sphere normalization
        pts -= pts.mean(0)
        scale = np.max(np.linalg.norm(pts, axis=1))
        if scale > 0:
            pts /= scale

        n_budget = self.cfg.data.num_points
        n = pts.shape[0]
        sel = rng.choice(n, n_budget, replace=n < n_budget)
        pts = pts[sel]

        if augment and self.cfg.data.augment:
            theta = rng.uniform(0, 2 * np.pi)
            c, s = np.cos(theta), np.sin(theta)
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            pts = pts @ rot.T
            pts *= rng.uniform(0.8, 1.25)
            pts += np.clip(
                0.01 * rng.standard_normal(pts.shape), -0.05, 0.05
            ).astype(np.float32)
        return pts, self._label(d, name)

    def _batch(self, items, rng, batch_size, augment):
        picks = rng.choice(len(items), batch_size, replace=len(items) < batch_size)
        loaded = [self._load(*items[p], rng, augment) for p in picks]
        return {
            "points": np.stack([p for p, _ in loaded]),
            "labels": np.asarray([l for _, l in loaded], np.int32),
            "mask": np.ones((batch_size, self.cfg.data.num_points), bool),
        }

    def train_batch(self, rng, batch_size):
        return self._batch(self.train_items, rng, batch_size, augment=True)

    def val_batches(self, rng, batch_size):
        from tpu3dsad_torch.data.pipeline import iter_val_batches

        items = self.val_items or self.train_items

        def load(it):
            pts, label = self._load(*it, rng, False)
            return {
                "points": pts,
                "labels": np.int32(label),
                "mask": np.ones(self.cfg.data.num_points, bool),
            }

        yield from iter_val_batches(items, load, batch_size)
