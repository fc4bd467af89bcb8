"""Configuration: frozen dataclasses mirroring tpu3dsad/config.py, with
key=value CLI overrides.

The port keeps its own copy of the fields that whole-scene inference,
detector and classifier training and evaluation read, with the
reference's names and defaults (pinned equal by
tests/test_torch_detector.py, tests/test_torch_train.py and
tests/test_torch_outdoor.py), so neither the
port nor a run on the card loads any module of the JAX package. A
reference `Config` works in its place: the port only reads these
attributes.

The `ssd3d_*` and `groupfree_*` fields of ModelConfig are the port's alone
(3DSSD, model.name='ssd3d', and Group-Free 3D, model.name='groupfree3d',
have no counterpart in the reference).

One default differs: `ops_fast_grouping` is False here (True in the
reference). The reference's default fast tier is lax.approx_max_k, which
exists only on the TPU; the port groups exactly unless asked for the
sorted tier (ops_fast_grouping=true ops_fast_mode=sorted, ops/sorted.py).
"""

from __future__ import annotations

import ast
import dataclasses
import typing
from dataclasses import dataclass, field, fields, replace
from typing import Any

import numpy as np


@dataclass(frozen=True)
class ModelConfig:
    # 'detector' | 'classifier' | 'ssd3d' | 'groupfree3d'
    name: str = "detector"
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
    # context parallelism: how many leading SA levels run point-sharded
    # over a mesh passed to the model as cp_mesh (parallel/point_sharded.py)
    cp_stages: int = 1
    cluster_nsample: int = 16
    # 'adaptive' = the radius bank; 'lineage' = the fixed-radius VoteNet
    # head (proposal_radius), which lineage checkpoints import into
    proposal_mode: str = "adaptive"
    proposal_radius: float = 0.3
    # proposal centers of the adaptive head: 'fps' over the votes, or
    # 'density' = FPS over the proposal_candidate_factor x num_proposals
    # votes of most neighbours within proposal_density_radius
    # (models/proposal.py::density_biased_fps)
    proposal_sampling: str = "fps"
    proposal_density_radius: float = 0.3
    proposal_candidate_factor: int = 4
    # objectness assignment zone and center-chamfer unit (losses.py)
    assign_near: float = 0.3
    assign_far: float = 0.6
    center_loss_norm: float = 1.0
    append_height: bool = True
    # classifier only: multi-scale grouping (pointnet2_cls_msg), else SSG
    classifier_msg: bool = False
    dropout: float = 0.5  # classifier head
    # name='ssd3d' only: 3DSSD (models/ssd3d.py), defaults mmdetection3d's
    # configs/3dssd/3dssd_4x4_kitti-3d-car.py. Per SA level, per sampler:
    # picks, mode ('D-FPS', 'F-FPS' or 'FS' = both, F's picks first) and
    # the end of its index range of the level's input (-1: the last point;
    # each range starts where the one before it ended)
    ssd3d_point_features: int = 1  # intensity
    ssd3d_npoints: tuple[tuple[int, ...], ...] = ((4096,), (512,),
                                                  (256, 256))
    ssd3d_fps_mods: tuple[tuple[str, ...], ...] = (("D-FPS",), ("FS",),
                                                   ("F-FPS", "D-FPS"))
    ssd3d_fps_ranges: tuple[tuple[int, ...], ...] = ((-1,), (-1,), (512, -1))
    ssd3d_radii: tuple[tuple[float, ...], ...] = (
        (0.2, 0.4, 0.8), (0.4, 0.8, 1.6), (1.6, 3.2, 4.8))
    ssd3d_nsamples: tuple[tuple[int, ...], ...] = (
        (32, 32, 64), (32, 32, 64), (32, 32, 32))
    ssd3d_mlps: tuple[tuple[tuple[int, ...], ...], ...] = (
        ((16, 16, 32), (16, 16, 32), (32, 32, 64)),
        ((64, 64, 128), (64, 64, 128), (64, 96, 128)),
        ((128, 128, 256), (128, 192, 256), (128, 256, 256)))
    ssd3d_aggregation: tuple[int, ...] = (64, 128, 256)
    # the vote layer's hidden widths and its offset clamp (m, per axis)
    ssd3d_vote_channels: tuple[int, ...] = (128,)
    ssd3d_vote_range: tuple[float, ...] = (3.0, 3.0, 2.0)
    # candidate generation: an MSG grouping of the last level around the
    # votes, convs with bias
    ssd3d_cg_radii: tuple[float, ...] = (4.8, 6.4)
    ssd3d_cg_nsamples: tuple[int, ...] = (16, 32)
    ssd3d_cg_mlps: tuple[tuple[int, ...], ...] = ((256, 256, 512),
                                                  (256, 512, 1024))
    ssd3d_shared_channels: tuple[int, ...] = (512, 128)
    ssd3d_branch_channels: tuple[int, ...] = (128,)  # class and regression
    ssd3d_bn_eps: float = 1e-3
    # the parse keeps the first ssd3d_max_output NMS survivors by score
    ssd3d_max_output: int = 100
    # name='groupfree3d' only: Group-Free 3D (models/groupfree.py), defaults
    # mmdetection3d's configs/groupfree3d/groupfree3d_head-L12-O256_4xb8_
    # scannet-seg.py; the backbone is the detector's (sa_*, fp_channels:
    # preset=groupfree3d sets FP2 to 288, the decoder's width d). KPS keeps
    # the groupfree_candidates seeds of most objectness
    groupfree_candidates: int = 256
    # the decoder: layers, attention heads and the FFN's hidden width
    groupfree_layers: int = 12
    groupfree_heads: int = 8
    groupfree_ffn: int = 2048
    # every box head's shared Linear + BN + ReLU widths
    groupfree_head_channels: tuple[int, ...] = (288, 288)
    # the parse: the boxes of the last groupfree_stages decoder stages,
    # each kept only where more than groupfree_min_points valid input
    # points lie in it
    groupfree_stages: int = 3
    groupfree_min_points: int = 5


@dataclass(frozen=True)
class DataConfig:
    # 'synthetic' | 'modelnet' | 'scannet' | 'sunrgbd' | 'kitti' | 'packed'
    # (data/packed.py)
    name: str = "scannet"
    root: str = ""
    num_points: int = 40960
    max_boxes: int = 64
    augment: bool = True
    use_color: bool = False  # rgb as 3 point features (in_features=3)
    # large-cloud preprocessing FPS (KITTI crop -> budget) on the card (B2)
    device_preproc: bool = False
    device_augment: bool = False  # flip/rot/scale inside the train step
    device_synth: bool = False  # synthetic batches made on the device
    aug_preset: str = "auto"  # 'auto' | 'custom' | a name in AUG_PRESETS
    aug_flip_x: bool = True
    aug_flip_y: bool = True
    aug_rot_range: float = 0.08726646  # half-range in rad (pi/36)
    aug_scale_min: float = 1.0
    aug_scale_max: float = 1.0
    vote_candidates: int = 3
    # int8 vote owners decoded in the step
    compact_votes: bool = False


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
    # > 1: k detector steps a call: one captured step replayed k times on
    # the card at one rank; k eager steps on the CPU and on a mesh of more
    # than one rank (train_lib.DetectorTrainBlock)
    steps_per_call: int = 1
    seed: int = 0
    ckpt_dir: str = "./ckpt"
    ckpt_every: int = 1  # epochs; the last epoch always saves
    log_every: int = 10  # steps
    eval_every: int = 10  # epochs; then the val sweep and the best mAP
    # a torch.profiler trace (CPU + CUDA) of the first epoch run, written
    # as a Chrome trace into this directory (train_detector.run_detector)
    profile_dir: str = ""
    # TensorBoard scalars beside the JSON lines, where
    # torch.utils.tensorboard imports (utils/metrics.py)
    tb_dir: str = ""
    # the mesh of ranks (one process a rank, parallel/mesh.py): sizes with
    # one -1 absorbing the rest, and the axes' names; training splits its
    # batch over the axis 'data' (train_lib: data parallelism)
    mesh_shape: tuple[int, ...] = (-1,)
    mesh_axes: tuple[str, ...] = ("data",)
    # TF32 for the MLP products on the card; distances stay fp32
    # (train_lib.apply_runtime_config)
    bf16_matmul: bool = True


@dataclass(frozen=True)
class EvalConfig:
    nms_iou: float = 0.25
    objectness_thresh: float = 0.05
    ap_iou_threshs: tuple[float, ...] = (0.25, 0.5)
    use_3d_nms: bool = True
    cls_nms: bool = True
    # suppress by the oriented BEV IoU that AP scores with (else the
    # axis-aligned hulls: 3D, or BEV with use_3d_nms=False)
    use_oriented_nms: bool = False
    per_class_proposal: bool = True
    conf_thresh: float = 0.05
    # evaluate <ckpt_dir>/best, the best-mAP snapshot training keeps
    use_best: bool = False


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    # 'xla' | 'pallas', accepted so that the reference's command lines
    # parse; any other value raises (train_lib.apply_runtime_config). It
    # selects nothing here: the port picks its kernels by the tensor's
    # device, and ops.use_impl("plain") is the one way to ask for the
    # plain ops
    ops_impl: str = "xla"
    # exact grouping unless set: the reference's default fast tier
    # (approx_max_k) is the TPU's (module docstring)
    ops_fast_grouping: bool = False
    # 'sorted' (exact kernel on Z-order-sorted views, ops/sorted.py) |
    # 'approx' (refused: TPU only)
    ops_fast_mode: str = "approx"


def _coerce_obj(obj: Any, typ: Any):
    """Coerce a value parsed by ast.literal_eval onto the annotated config
    type, recursing through nested tuples."""
    if typing.get_origin(typ) is tuple:
        args = typing.get_args(typ)
        elem = args[0] if args else str
        if not isinstance(obj, (list, tuple)):
            obj = (obj,)  # '(80)' evaluates to a scalar: promote
        return tuple(_coerce_obj(o, elem) for o in obj)
    if typ is bool:
        return bool(obj)
    if typ is int:
        return int(obj)
    if typ is float:
        return float(obj)
    if not isinstance(obj, str):
        raise ValueError(
            f"expected a string for this config field, got {obj!r} "
            f"({type(obj).__name__}) — quote it if it is meant as a name")
    return obj


def _coerce(val: str, typ: Any):
    """One override's text -> the field's type. Tuples, nested ones too,
    parse as Python literals; unquoted names fall back to a flat split."""
    if typing.get_origin(typ) is tuple:
        args = typing.get_args(typ)
        elem = args[0] if args else str
        s = val.strip()
        if s in ("()", ""):
            return ()
        try:
            obj = ast.literal_eval(s)
        except (ValueError, SyntaxError):
            parts = [p for p in s.strip("()[] ").split(",") if p.strip()]
            return tuple(_coerce(p.strip(), elem) for p in parts)
        return _coerce_obj(obj, typ)
    if typ is bool:
        return val.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(val)
    if typ is float:
        return float(val)
    return val


def _set_path(obj, path, val):
    name = path[0]
    if name not in {f.name for f in fields(obj)}:
        valid = [f.name for f in fields(obj)]
        raise ValueError(f"unknown config key {name!r}; valid: {valid}")
    if len(path) == 1:
        typ = typing.get_type_hints(type(obj))[name]
        return replace(obj, **{name: _coerce(val, typ)})
    return replace(obj, **{name: _set_path(getattr(obj, name), path[1:], val)})


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply 'section.key=value' (or 'key=value' for top-level) overrides."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, val = ov.split("=", 1)
        cfg = _set_path(cfg, key.split("."), val)
    return cfg


def parse_cli(argv: list[str]) -> Config:
    """The Config of a command line: presets expanded, then overrides."""
    from tpu3dsad_torch.presets import expand

    return apply_overrides(Config(), expand([a for a in argv if "=" in a]))


def describe(cfg: Config) -> str:
    return "\n".join(
        f"{sec.name}: {getattr(cfg, sec.name)}" for sec in dataclasses.fields(cfg)
    )


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
