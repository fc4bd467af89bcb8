"""knn and three_nn — plain PyTorch (counterpart of tpu3dsad/ops/xla/knn.py).

Squared distances in the |a|² + |b|² − 2ab form in fp32, clamped at 0.
The cross term is a matrix product pinned to full fp32 in both directions
(TF32 off inside it, whatever train.bf16_matmul set for the MLPs), as the
reference pins it at Precision.HIGHEST (ops/xla/common.py); the forward
product is the custom op tpu3dsad_torch::fp32_cross, so an exported
program pins it too;
masked supports sit at +inf; the k nearest come from a stable sort, so
distance ties go to the lower support index as `lax.top_k` gives them.

knn forms the [B, M, N] matrix whole up to _SLAB_LIMIT elements, and
above it scans the support in slabs of index order with a running best k,
concatenated before each slab's candidates so that ties stay with the
lower index (the reference's _knn_chunked). three_nn's largest call on the
main path is [32, 1024, 512], so it always forms the matrix whole: it is
the exported program's fp32_cross node and stays as it is.
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


@torch.library.custom_op("tpu3dsad_torch::fp32_cross", mutates_args=(),
                         schema="(Tensor a, Tensor b) -> Tensor")
def fp32_cross(a, b):
    """a [B,M,3] @ b [B,N,3]^T with TF32 off. A custom op, so that a
    program exported by torch.export keeps the switch (a node of this op
    where a plain bmm would run at the process's matmul precision)."""
    with fp32_matmul():
        return torch.bmm(a, b.transpose(-1, -2))


@fp32_cross.register_fake
def _(a, b):
    return a.new_empty((a.shape[0], a.shape[1], b.shape[1]))


class _Fp32Cross(torch.autograd.Function):
    """a [B,M,3] @ b [B,N,3]^T with fp32 products forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fp32_cross(a, b)

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


# cap on B*M*slab elements of one distance matrix (~1 GB fp32), as in the
# reference
_SLAB_LIMIT = 1 << 28


def _masked_sqdist(query, support, valid):
    d2 = pairwise_sqdist(query, support)
    return torch.where(valid[:, None, :], d2, torch.inf)


def _smallest(d2: torch.Tensor, k: int):
    """The k smallest along the last axis, ties to the lower position."""
    d2, order = torch.sort(d2, dim=-1, stable=True)
    return d2[..., :k], order[..., :k]


def _knn_direct(query, support, k, valid):
    d2, idx = _smallest(_masked_sqdist(query, support, valid), k)
    return d2, idx.int()


def _knn_chunked(query, support, k, valid):
    """Scan support slabs in index order, merging a running best k."""
    B, M = query.shape[:2]
    N = support.shape[1]
    s = max(k, _SLAB_LIMIT // max(B * M, 1))
    best_d = query.new_full((B, M, k), torch.inf, dtype=torch.float32)
    best_i = torch.zeros((B, M, k), dtype=torch.int32, device=query.device)
    for off in range(0, N, s):
        # a last slab shorter than k adds what it has (the reference pads
        # it with masked points, which the running best always outranks)
        nd, ci = _smallest(_masked_sqdist(query, support[:, off:off + s],
                                          valid[:, off:off + s]), k)
        cand_d = torch.cat([best_d, nd], -1)  # best first: ties stay lower
        cand_i = torch.cat([best_i, ci.int() + off], -1)
        best_d, sel = _smallest(cand_d, k)
        best_i = torch.gather(cand_i, -1, sel)
    return best_d, best_i


def knn(query: torch.Tensor, support: torch.Tensor, k: int,
        support_mask: torch.Tensor | None = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """query [B,M,3], support [B,N,3] -> (d2 [B,M,k] fp32, idx [B,M,k]
    int32), the k nearest valid supports, ties to the lower index."""
    B, N, _ = support.shape
    M = query.shape[1]
    valid = (torch.ones((B, N), dtype=torch.bool, device=support.device)
             if support_mask is None else support_mask.bool())
    if B * M * N <= _SLAB_LIMIT:
        return _knn_direct(query, support, k, valid)
    return _knn_chunked(query, support, k, valid)
