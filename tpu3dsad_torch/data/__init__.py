"""Datasets and the input pipeline (tpu3dsad/data): synthetic, ScanNet,
SUN RGB-D, KITTI-style outdoor and packed splits, and ModelNet-style
classification clouds. Every loader gives
fixed-shape padded numpy batches with masks; `Batcher` makes them ahead on
a thread and `packed.device_prefetch` copies them to the card. The
synthetic dataset can also make its train batches on the card
(device_pipeline.synthetic_detection_batch)."""

from tpu3dsad_torch.data.pipeline import Batcher, pad_boxes, pad_points
from tpu3dsad_torch.data.registry import get_dataset

__all__ = ["Batcher", "pad_points", "pad_boxes", "get_dataset"]
