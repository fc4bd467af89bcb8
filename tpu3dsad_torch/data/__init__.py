"""Data for the detector: the synthetic dataset and the on-card input
pipeline (training), the KITTI-style outdoor dataset with its host
preprocessing (evaluation, config #4). The other host-fed datasets wait
for ROADMAP A7.2."""

from tpu3dsad_torch.data.registry import SyntheticDetectionDataset, get_dataset

__all__ = ["SyntheticDetectionDataset", "get_dataset"]
