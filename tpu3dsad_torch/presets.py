"""Named config presets: bundles of `section.key=value` overrides
(tpu3dsad/presets.py), applied before the user's own overrides, so
`preset=outdoor train.lr=5e-4` starts from the outdoor recipe and then
adjusts it. Presets carry only what differs from the dataclass defaults
(the ScanNet-scale indoor recipe).
"""

from __future__ import annotations

PRESETS: dict[str, list[str]] = {
    # benchmark config #2 scale: SUN RGB-D (20k pts, 10 classes)
    "sunrgbd": [
        "data.name=sunrgbd",
        "data.num_points=20480",
        "model.num_classes=10",
    ],
    # benchmark config #3: ScanNet V2 (40k pts, 18 classes) == the
    # dataclass defaults; listed so `preset=scannet` is valid and explicit
    "scannet": [
        "data.name=scannet",
    ],
    # benchmark config #4: KITTI-style outdoor. Indoor constants do not
    # transfer: SA radii, the assignment zone and the radius bank scale to
    # car size, the center chamfer is measured in assign_near units
    # (model.center_loss_norm, losses.py), and gradients are clipped.
    "outdoor": [
        "data.name=kitti",
        "data.num_points=16384",
        "data.max_boxes=16",
        "model.num_classes=3",
        "model.sa_radii=(0.8,1.6,3.2,6.4)",
        "model.sa_npoints=(2048,1024,512,256)",
        "model.cluster_radius_bank=(0.4,0.8,1.6)",
        "model.assign_near=1.5",
        "model.assign_far=3.0",
        "model.center_loss_norm=1.5",
        "train.grad_clip=1.0",
        "train.lr_decay_steps=(450,750,1000)",
        "train.lr_decay_rates=(0.3,0.3,0.3)",
        "train.num_epochs=1200",
    ],
    # 3DSSD (models/ssd3d.py) at mmdetection3d's KITTI car setting
    # (configs/3dssd/3dssd_4x4_kitti-3d-car.py; the model's widths are the
    # ModelConfig ssd3d_* defaults): 16384 points of xyz + intensity, one
    # class, its test_cfg's NMS at IoU 0.1 with a score threshold of 0,
    # suppressing by the oriented BEV IoU; fp32 products
    "3dssd": [
        "model.name=ssd3d",
        "model.num_classes=1",
        "data.name=kitti",
        "data.num_points=16384",
        "data.max_boxes=16",
        "eval.nms_iou=0.1",
        "eval.objectness_thresh=0.0",
        "eval.use_oriented_nms=true",
        "eval.cls_nms=false",
        "train.bf16_matmul=false",
    ],
    # Group-Free 3D (models/groupfree.py) at mmdetection3d's ScanNet setting
    # L12-O256 (configs/groupfree3d/groupfree3d_head-L12-O256_4xb8_scannet-
    # seg.py; the decoder's widths are the ModelConfig groupfree_*
    # defaults): 50000 points of xyz (51200, the 2048-multiple bucket), 18
    # classes, the backbone's FP2 at 288, its test_cfg's class-aware 3D NMS
    # at IoU 0.25 with a score threshold of 0; fp32 products
    "groupfree3d": [
        "model.name=groupfree3d",
        "model.num_classes=18",
        "model.fp_channels=((256,256),(256,288))",
        "model.append_height=false",
        "data.name=scannet",
        "data.num_points=51200",
        "eval.nms_iou=0.25",
        "eval.objectness_thresh=0.0",
        "eval.use_3d_nms=true",
        "eval.cls_nms=true",
        "eval.use_oriented_nms=false",
        "train.bf16_matmul=false",
    ],
    # benchmark config #1: the PointNet++ SSG classifier, 1024-point clouds
    "classifier": [
        "model.name=classifier",
        "data.num_points=1024",
    ],
}


def expand(overrides: list[str]) -> list[str]:
    """Expand any `preset=<name>` items in place (preset overrides first,
    then everything the user wrote after it; later wins)."""
    out: list[str] = []
    for ov in overrides:
        if ov.startswith("preset="):
            name = ov.split("=", 1)[1]
            if name not in PRESETS:
                raise ValueError(
                    f"unknown preset {name!r}; available: {sorted(PRESETS)}")
            out.extend(PRESETS[name])
        else:
            out.append(ov)
    return out
