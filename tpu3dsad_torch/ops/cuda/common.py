"""Device, dtype and layout of the kernel wrappers' arguments (shapes and
ranges are checked by ops/args.py)."""

from __future__ import annotations

import torch


def points_arg(t: torch.Tensor, name: str) -> torch.Tensor:
    """A contiguous fp32 CUDA tensor, or raise."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    return t.contiguous()


def mask_arg(mask: torch.Tensor | None, xyz: torch.Tensor) -> torch.Tensor | None:
    """Validity as contiguous uint8 on xyz's device, or None."""
    if mask is None:
        return None
    if mask.device != xyz.device:
        raise ValueError(f"mask must be on {xyz.device}, got {mask.device}")
    return mask.bool().contiguous().view(torch.uint8)


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
