"""Dataset registry (tpu3dsad/data/registry.py): 'synthetic' and 'kitti'.

A dataset exposes mean_sizes [NC,3], class_names, num_classes and
steps_per_epoch(batch_size); KITTI also train_batch(rng, bs) and
val_batches(rng, bs), padded numpy dicts. The synthetic dataset trains on
batches made on the card (`data.device_synth`,
device_pipeline.synthetic_detection_batch); its host train and val batches
and the other real datasets (ScanNet, SUN RGB-D, packed) wait for
ROADMAP A7.2.
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


def get_dataset(cfg, *, device="cuda"):
    """The dataset of cfg.data.name; `device` is where a dataset that
    preprocesses on the device does so (KITTI's device_fps)."""
    if cfg.data.name == "synthetic":
        return SyntheticDetectionDataset(cfg)
    if cfg.data.name == "kitti":
        from tpu3dsad_torch.data.kitti import KittiDetectionDataset

        return KittiDetectionDataset(cfg, device=device)
    raise NotImplementedError(
        f"data.name={cfg.data.name!r}: ScanNet, SUN RGB-D and packed scenes "
        "are not ported yet (ROADMAP A7.2); 'synthetic' and 'kitti' are")
