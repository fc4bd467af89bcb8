"""Configuration: frozen dataclasses mirroring tpu3dsad/config.py.

The port keeps its own copy of the fields that whole-scene inference reads,
with the reference's names and defaults (pinned equal by
tests/test_torch_detector.py), so neither the port nor a run on the card
loads any module of the JAX package. A reference `Config` works in its
place: the port only reads these attributes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class ModelConfig:
    num_classes: int = 18
    num_heading_bins: int = 12
    num_proposals: int = 256
    vote_factor: int = 1
    sa_npoints: tuple[int, ...] = (2048, 1024, 512, 256)
    sa_radii: tuple[float, ...] = (0.2, 0.4, 0.8, 1.2)
    sa_nsamples: tuple[int, ...] = (64, 32, 16, 16)
    sa_channels: tuple[tuple[int, ...], ...] = (
        (64, 64, 128),
        (128, 128, 256),
        (128, 128, 256),
        (128, 128, 256),
    )
    fp_channels: tuple[tuple[int, ...], ...] = ((256, 256), (256, 256))
    seed_feat_dim: int = 256
    cluster_radius_bank: tuple[float, ...] = (0.15, 0.3, 0.6)
    cluster_nsample: int = 16
    proposal_mode: str = "adaptive"  # 'lineage' is not ported (ROADMAP A5b)
    proposal_sampling: str = "fps"  # 'density' is not ported (ROADMAP A5b)
    append_height: bool = True


@dataclass(frozen=True)
class EvalConfig:
    nms_iou: float = 0.25
    objectness_thresh: float = 0.05
    use_3d_nms: bool = True
    cls_nms: bool = True
    use_oriented_nms: bool = False  # not ported (ROADMAP A5b)


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)


def class_mean_sizes(num_classes: int) -> np.ndarray:
    """Deterministic size priors spanning small to large objects, [NC, 3]
    (tpu3dsad/data/synthetic.py::class_mean_sizes)."""
    base = np.array(
        [
            [0.6, 0.6, 0.9],   # chair-ish
            [1.6, 0.9, 0.75],  # table-ish
            [2.0, 1.0, 0.9],   # sofa-ish
            [0.5, 0.5, 1.6],   # cabinet-ish
            [1.0, 2.0, 0.6],   # bed-ish
            [0.4, 0.4, 0.5],   # nightstand-ish
        ],
        np.float32,
    )
    reps = int(np.ceil(num_classes / len(base)))
    scaled = np.concatenate([base * (1 + 0.3 * r) for r in range(reps)])
    return scaled[:num_classes]
