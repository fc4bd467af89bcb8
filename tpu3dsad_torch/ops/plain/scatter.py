"""Row scatter-add — plain PyTorch version of csrc/scatter.cu.

The gather/group backward (tpu3dsad/ops/xla/group.py::_scatter_rows):
out[b, n, c] = sum over u of [idx[b, u] == n] * g[b, u, c]. Rows whose
index is < 0 or >= n add nothing, as in the Pallas kernel (the reference's
CPU tier, `.at[].add`, would wrap -1 to n - 1 instead). Such rows are sent
to a sink row past the end, which is dropped.

The output is fp32 for fp32 (or narrower) g and fp64 for fp64 g, so a
float64 reference can be taken on the same inputs.
"""

from __future__ import annotations

import torch

from tpu3dsad_torch.ops.args import check_scatter


def scatter_rows(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """g [B,U,C] float, idx [B,U] int -> [B,n,C]."""
    check_scatter(g, idx, n)
    B, U, C = g.shape
    idx = idx.long()
    rows = torch.where((idx >= 0) & (idx < n), idx, n)
    rows = rows + torch.arange(B, device=g.device)[:, None] * (n + 1)
    dtype = torch.promote_types(g.dtype, torch.float32)
    out = torch.zeros(B * (n + 1), C, dtype=dtype, device=g.device)
    out.index_put_((rows.reshape(-1),), g.reshape(B * U, C).to(dtype),
                   accumulate=True)
    return out.view(B, n + 1, C)[:, :n]
