"""Configuration: frozen dataclasses mirroring tpu3dsad/config.py.

The port keeps its own copy of the fields that whole-scene inference and
detector training read, with the reference's names and defaults (pinned
equal by tests/test_torch_detector.py and tests/test_torch_train.py), so
neither the port nor a run on the card loads any module of the JAX package.
A reference `Config` works in its place: the port only reads these
attributes.
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
    # objectness assignment zone and center-chamfer unit (losses.py)
    assign_near: float = 0.3
    assign_far: float = 0.6
    center_loss_norm: float = 1.0
    append_height: bool = True


@dataclass(frozen=True)
class DataConfig:
    name: str = "scannet"  # only 'synthetic' is ported (ROADMAP A7)
    num_points: int = 40960
    max_boxes: int = 64
    augment: bool = True
    device_augment: bool = False  # flip/rot/scale inside the train step
    device_synth: bool = False  # synthetic batches made on the device
    aug_preset: str = "auto"  # 'auto' | 'custom' | a name in AUG_PRESETS
    aug_flip_x: bool = True
    aug_flip_y: bool = True
    aug_rot_range: float = 0.08726646  # half-range in rad (pi/36)
    aug_scale_min: float = 1.0
    aug_scale_max: float = 1.0
    vote_candidates: int = 3


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8
    num_epochs: int = 180
    lr: float = 1e-3
    lr_decay_steps: tuple[int, ...] = (80, 120, 160)  # epochs
    lr_decay_rates: tuple[float, ...] = (0.1, 0.1, 0.1)
    weight_decay: float = 0.0  # > 0 selects AdamW
    bn_momentum_init: float = 0.5  # torch convention, halved every N epochs
    bn_momentum_max: float = 0.999  # cap on flax's running-average weight
    bn_decay_epochs: int = 20
    grad_clip: float = 0.0  # global-norm clip, 0 = off
    steps_per_call: int = 1  # only 1 is ported (ROADMAP A7)
    seed: int = 0
    ckpt_dir: str = "./ckpt"
    ckpt_every: int = 1  # epochs; the last epoch always saves
    log_every: int = 10  # steps
    eval_every: int = 10  # epochs; evaluate is not ported (ROADMAP A7)
    mesh_shape: tuple[int, ...] = (-1,)  # one device only (ROADMAP A11)
    # TF32 for the MLP products on the card; distances stay fp32
    # (train_lib.apply_runtime_config)
    bf16_matmul: bool = True


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
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
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
