"""Wrapper of the greedy NMS walk kernel (csrc/nms.cu), which replaces the
plain version's Python loop of K steps (ops/plain/nms.py; the reference's
XLA fori_loop, tpu3dsad/ops/nms.py:81-104) with one launch: one CTA a
cloud orders the candidates, builds the suppression bitmask in shared
memory and walks it in one warp.

`launches` counts the kernel's launches by this wrapper, so a run can show
that its NMS went through the kernel: one a parse_predictions call.
"""

from __future__ import annotations

import contextlib

import torch

from tpu3dsad_torch.ops.args import check_nms
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda.common import points_arg, ptr, stream

MAX_K = 1024  # candidates a cloud; the C entry refuses more

launches = 0


def greedy_suppress(iou: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """iou [B,K,K] fp32 CUDA, scores [B,K] fp32, valid [B,K] bool -> keep
    [B,K] bool, bitwise the plain version's. iou_thresh is compared in
    fp32, as torch compares an fp32 tensor with a Python float. scores is
    read through its strides (no copy)."""
    global launches
    check_nms(iou, scores, valid)
    iou = points_arg(iou, "iou")
    if scores.device != iou.device or valid.device != iou.device:
        raise ValueError(f"scores and valid must be on {iou.device}")
    if scores.dtype != torch.float32:
        raise TypeError(f"scores must be float32, got {scores.dtype}")
    valid = valid.contiguous().view(torch.uint8)
    B, K = scores.shape
    dev = iou.device
    lib = build.library()
    keep = torch.empty(B, K, dtype=torch.bool, device=dev)
    here = (contextlib.nullcontext()
            if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))
    with here:
        err = lib.tpu3dsad_nms_walk(
            ptr(iou), ptr(scores), scores.stride(0), scores.stride(1),
            ptr(valid), ptr(keep), B, K, iou_thresh, stream(iou))
    build.check(err, "tpu3dsad_nms_walk")
    launches += 1
    return keep
