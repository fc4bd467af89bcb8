"""Dataset registry and the detection-dataset protocol
(tpu3dsad/data/registry.py).

Every dataset exposes mean_sizes [NC,3], class_names, num_classes,
steps_per_epoch(batch_size), train_batch(rng, batch_size) -> a padded
numpy dict, and val_batches(rng, batch_size) -> an iterator of them.
Registered: synthetic, scannet, sunrgbd, kitti, packed, and modelnet,
the classification dataset (data/modelnet.py: train_batch, val_batches,
num_classes and steps_per_epoch, no boxes).
"""

from __future__ import annotations

import numpy as np

from tpu3dsad_torch.config import class_mean_sizes
from tpu3dsad_torch.data.synthetic import detection_batch


class SyntheticDetectionDataset:
    """Procedural indoor scenes (data.name=synthetic): an endless train
    stream and a fixed val set of 4 batches drawn from default_rng(999).
    With data.device_synth the train batches are made on the card instead
    (device_pipeline.synthetic_detection_batch)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.num_classes = cfg.model.num_classes
        self.mean_sizes = class_mean_sizes(self.num_classes)
        self.class_names = [f"class{i}" for i in range(self.num_classes)]
        self._val_batches = 4

    def steps_per_epoch(self, batch_size: int) -> int:
        return max(1, 64 // batch_size)

    def _batch(self, rng, batch_size):
        return detection_batch(
            rng, batch_size, self.cfg.data.num_points, self.num_classes,
            self.cfg.data.max_boxes,
            vote_candidates=self.cfg.data.vote_candidates)

    def train_batch(self, rng: np.random.Generator, batch_size: int) -> dict:
        return self._batch(rng, batch_size)

    def val_batches(self, rng: np.random.Generator, batch_size: int):
        val_rng = np.random.default_rng(999)
        for _ in range(self._val_batches):
            yield self._batch(val_rng, batch_size)


def get_dataset(cfg, *, device="cuda"):
    """The dataset of cfg.data.name; `device` is where a dataset that
    preprocesses on the device does so (KITTI's device_fps)."""
    name = cfg.data.name
    if name == "synthetic":
        return SyntheticDetectionDataset(cfg)
    if name == "scannet":
        from tpu3dsad_torch.data.scannet import ScanNetDetectionDataset

        return ScanNetDetectionDataset(cfg)
    if name == "sunrgbd":
        from tpu3dsad_torch.data.sunrgbd import SunRGBDDetectionDataset

        return SunRGBDDetectionDataset(cfg)
    if name == "kitti":
        from tpu3dsad_torch.data.kitti import KittiDetectionDataset

        return KittiDetectionDataset(cfg, device=device)
    if name == "packed":
        from tpu3dsad_torch.data.packed import PackedDetectionDataset

        return PackedDetectionDataset(cfg)
    if name == "modelnet":
        from tpu3dsad_torch.data.modelnet import ModelNetClassificationDataset

        return ModelNetClassificationDataset(cfg)
    raise ValueError(f"unknown dataset {name!r}")
