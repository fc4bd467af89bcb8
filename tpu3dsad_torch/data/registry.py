"""Dataset registry (tpu3dsad/data/registry.py), synthetic only.

A dataset exposes mean_sizes [NC,3], class_names, num_classes and
steps_per_epoch(batch_size). The port trains on synthetic batches made on
the card (`data.device_synth`, device_pipeline.synthetic_detection_batch),
so the host numpy `train_batch` / `val_batches` and the real datasets
(ScanNet, SUN RGB-D, KITTI, packed) wait for ROADMAP A7.
"""

from __future__ import annotations

from tpu3dsad_torch.config import class_mean_sizes


class SyntheticDetectionDataset:
    """Procedural indoor scenes (data.name=synthetic)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.num_classes = cfg.model.num_classes
        self.mean_sizes = class_mean_sizes(self.num_classes)
        self.class_names = [f"class{i}" for i in range(self.num_classes)]

    def steps_per_epoch(self, batch_size: int) -> int:
        return max(1, 64 // batch_size)


def get_dataset(cfg):
    if cfg.data.name == "synthetic":
        return SyntheticDetectionDataset(cfg)
    raise NotImplementedError(
        f"data.name={cfg.data.name!r}: host-fed datasets are not ported yet "
        "(ROADMAP A7); only 'synthetic' is")
