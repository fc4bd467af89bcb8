"""Decode raw proposal params into box fields (tpu3dsad/models/decode.py).

Channel layout of raw [B, P, 2 + 3 + NH*2 + NS*4 + NC]:
  objectness(2) | center offset(3) | heading cls(NH) | heading res norm(NH) |
  size cls(NS) | size res norm(NS*3) | semantic cls(NC)
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dsad_torch.ops.boxes import angle_from_bin
from tpu3dsad_torch.utils.constants import device_constant


def decode_proposals(raw, base_xyz, mean_sizes, num_heading_bins: int):
    """raw [B,P,C], base_xyz [B,P,3] (cluster centers), mean_sizes [NS,3].

    Returns dict of decoded fields (lineage end_points naming)."""
    NH = num_heading_bins
    NS = len(mean_sizes)
    sizes = device_constant(mean_sizes, raw.device)
    splits = [2, 3, NH, NH, NS, NS * 3]
    parts = torch.split(raw, splits + [raw.shape[-1] - sum(splits)], -1)
    objectness, offset, heading_scores, heading_res_norm, size_scores, \
        size_res_norm, sem_cls_scores = parts
    size_res_norm = size_res_norm.reshape(*raw.shape[:2], NS, 3)
    return {
        "objectness_scores": objectness,
        "center": base_xyz + offset,
        "heading_scores": heading_scores,
        "heading_residuals_normalized": heading_res_norm,
        "heading_residuals": heading_res_norm * (np.pi / NH),
        "size_scores": size_scores,
        "size_residuals_normalized": size_res_norm,
        "size_residuals": size_res_norm * sizes,
        "sem_cls_scores": sem_cls_scores,
    }


def predicted_boxes(end_points, mean_sizes, num_heading_bins: int):
    """Argmax decode to concrete boxes: (center [B,P,3], size [B,P,3],
    heading [B,P], sem_cls [B,P], objectness_prob [B,P])."""
    center = end_points["center"]
    sizes = device_constant(mean_sizes, center.device)
    hcls = end_points["heading_scores"].argmax(-1)
    hres = end_points["heading_residuals"].gather(-1, hcls[..., None])[..., 0]
    heading = angle_from_bin(hcls, hres, num_heading_bins)

    scls = end_points["size_scores"].argmax(-1)  # [B,P]
    sres = end_points["size_residuals"].gather(
        -2, scls[..., None, None].expand(*scls.shape, 1, 3))[..., 0, :]
    size = (sizes[scls] + sres).clamp_min(1e-4)

    sem = end_points["sem_cls_scores"].argmax(-1)
    obj_prob = torch.softmax(end_points["objectness_scores"], -1)[..., 1]
    return center, size, heading, sem, obj_prob
