"""Wrapper of the oriented BEV IoU kernel (csrc/iou.cu), which replaces the
plain version's chain of elementwise ops (ops/plain/iou.py: about 20
launches a clip step over every pair's padded polygon, four int64 cumsums;
the reference's XLA in tpu3dsad/ops/boxes.py) with one launch: a thread a
pair, the clip in registers, and only for the pairs whose footprints can
meet.

`launches` counts the kernel's launches by this wrapper, one an
nms_oriented call, so a run can show that its oriented NMS went through
the kernel; `reset()` zeroes it.
"""

from __future__ import annotations

import contextlib

import torch

from tpu3dsad_torch.ops.args import check_iou
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda.common import points_arg, ptr, stream

MAX_K = 1024  # boxes a cloud on either side; the C entry refuses more

launches = 0


def reset() -> None:
    global launches
    launches = 0


def oriented_bev_iou(corners_a: torch.Tensor,
                     corners_b: torch.Tensor) -> torch.Tensor:
    """corners_a [B,K,8,3], corners_b [B,L,8,3] fp32 CUDA -> iou [B,K,L]
    fp32: the plain chain's arithmetic in its order (ops/plain/iou.py),
    exactly 0 where the two footprints' bounds lie apart. K and L are at
    most MAX_K."""
    global launches
    check_iou(corners_a, corners_b)
    (B, K), L = corners_a.shape[:2], corners_b.shape[1]
    if max(K, L) > MAX_K:
        raise ValueError(f"K = {K} and L = {L} boxes a cloud: the oriented "
                         f"IoU kernel takes at most MAX_K = {MAX_K}")
    a = points_arg(corners_a, "corners_a")
    b = points_arg(corners_b, "corners_b")
    dev = a.device
    if b.device != dev:
        raise ValueError(f"corners_b must be on {dev}, got {b.device}")
    lib = build.library()
    iou = torch.empty(B, K, L, dtype=torch.float32, device=dev)
    here = (contextlib.nullcontext()
            if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))
    with here:
        err = lib.tpu3dsad_oriented_iou(ptr(a), ptr(b), ptr(iou), B, K, L,
                                        stream(a))
    build.check(err, "tpu3dsad_oriented_iou")
    launches += 1
    return iou
