"""Wrapper of the oriented BEV IoU kernel (csrc/iou.cu), which replaces the
plain version's chain of elementwise ops (ops/plain/iou.py: about 20
launches a clip step over every pair's padded polygon, four int64 cumsums;
the reference's XLA in tpu3dsad/ops/boxes.py) with one launch: a thread a
pair, the clip in registers, and only for the pairs whose footprints can
meet.

Counters, so a run can show that its oriented NMS went through the kernel
and how much of it clipped:

  * `launches`: the kernel's launches by this wrapper, one an nms_oriented
    call;
  * `pairs`: the box pairs (B K L) of those launches;
  * `clipped()`: the pairs whose footprints' bounds met, so that the kernel
    clipped them; the kernel adds them up on the device (one atomic a
    CTA) and this function reads them back (a synchronisation: never on
    the served path). `reset()` zeroes all three.
"""

from __future__ import annotations

import contextlib

import torch

from tpu3dsad_torch.ops.args import check_iou
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda.common import points_arg, ptr, stream

MAX_K = 1024  # boxes a cloud on either side; the C entry refuses more

launches = 0
pairs = 0
_clipped: dict[int, torch.Tensor] = {}  # device index -> int64 counter


def _counter(dev: torch.device) -> torch.Tensor | None:
    """The device's clip counter, made on first use; None (count nothing)
    where that first use is inside a CUDA graph capture, which would
    record the counter's zeroing into the graph."""
    counter = _clipped.get(dev.index)
    if counter is None and not torch.cuda.is_current_stream_capturing():
        counter = _clipped[dev.index] = torch.zeros(
            (), dtype=torch.int64, device=dev)
    return counter


def clipped() -> int:
    """The pairs clipped since the last reset(), over every device."""
    return sum(int(c.item()) for c in _clipped.values())


def reset() -> None:
    global launches, pairs
    launches = pairs = 0
    for counter in _clipped.values():
        counter.zero_()


def oriented_bev_iou(corners_a: torch.Tensor,
                     corners_b: torch.Tensor) -> torch.Tensor:
    """corners_a [B,K,8,3], corners_b [B,L,8,3] fp32 CUDA -> iou [B,K,L]
    fp32: the plain chain's arithmetic in its order (ops/plain/iou.py),
    exactly 0 where the two footprints' bounds lie apart. K and L are at
    most MAX_K."""
    global launches, pairs
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
        err = lib.tpu3dsad_oriented_iou(ptr(a), ptr(b), ptr(iou),
                                        ptr(_counter(dev)), B, K, L,
                                        stream(a))
    build.check(err, "tpu3dsad_oriented_iou")
    launches += 1
    pairs += B * K * L
    return iou
