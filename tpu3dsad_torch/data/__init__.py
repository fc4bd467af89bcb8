"""Data for detector training (tpu3dsad/data): the synthetic dataset and
the on-card input pipeline. Host-fed datasets wait for ROADMAP A7."""

from tpu3dsad_torch.data.registry import SyntheticDetectionDataset, get_dataset

__all__ = ["SyntheticDetectionDataset", "get_dataset"]
