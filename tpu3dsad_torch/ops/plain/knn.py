"""three_nn — plain PyTorch (counterpart of tpu3dsad/ops/xla/knn.py).

Squared distances in the |a|² + |b|² − 2ab form in fp32, clamped at 0.
The cross term is a matrix product pinned to full fp32 in both directions
(TF32 off inside it, whatever train.bf16_matmul set for the MLPs), as the
reference pins it at Precision.HIGHEST (ops/xla/common.py);
masked supports sit at +inf; the 3 nearest come from a stable sort, so
distance ties go to the lower support index as `lax.top_k` gives them.
The main path's largest call is [32, 1024, 512], so the [B, M, N] matrix
is formed whole (the reference's slab scan above 2^28 elements is not
needed at these shapes).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_matmul():
    """Run a block with TF32 off for CUDA matrix products, then restore."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class _Fp32Cross(torch.autograd.Function):
    """a [B,M,3] @ b [B,N,3]^T with fp32 products forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with fp32_matmul():
            return torch.bmm(a, b.transpose(-1, -2))

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        with fp32_matmul():
            return torch.bmm(grad, b), torch.bmm(grad.transpose(-1, -2), a)


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B,M,3], b [B,N,3] -> [B,M,N] fp32."""
    a, b = a.float(), b.float()
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    d2 = a2 + b2.transpose(-1, -2) - 2.0 * _Fp32Cross.apply(a, b)
    return d2.clamp_min(0.0)


def three_nn(query: torch.Tensor, support: torch.Tensor,
             support_mask: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """query [B,M,3], support [B,N,3] -> (d2 [B,M,3], idx [B,M,3] int32)."""
    d2 = pairwise_sqdist(query, support)
    if support_mask is not None:
        d2 = torch.where(support_mask.bool()[:, None, :], d2, torch.inf)
    d2, order = torch.sort(d2, dim=-1, stable=True)
    return d2[..., :3], order[..., :3].int()
