"""Multi-head attention and the post-norm transformer decoder layer of
Group-Free 3D (models/groupfree.py), channels-last: queries [B, L, d],
keys [B, S, d].

`MultiheadAttention` is torch.nn.MultiheadAttention's algebra, batch
first: the in-projection (one Linear of d -> 3 d with bias, the query's,
key's and value's rows in that order), heads of d / h channels, the query
scaled by sqrt(1 / (d / h)), softmax(Q K^T) V per head, padded keys at
-inf, then the out-projection with bias. Its inputs already hold their
position terms: mmdet3d's GroupFree3DMHA adds the position embedding to
the query, to the key *and* to the value, and in both of Group-Free's
attentions the key and the value are one tensor, so the module takes the
queries' input and one input for keys and values (none: self-attention,
one in-projection for all three).

`DecoderLayer` is mmcv's BaseTransformerLayer with operation_order
('self_attn', 'norm', 'cross_attn', 'norm', 'ffn', 'norm'), post-norm:

    u = q + qp;  q = LN(q + MHA_self(u, u, u))
    q = LN(q + MHA_cross(q + qp, k + kp, k + kp))   (padded keys masked)
    q = LN(q + Linear(ReLU(Linear(q))))

The published dropouts (attention 0.1, projection 0.1, FFN 0.1) are the
identity at inference and are not held, so a train-mode forward (BatchNorm
calibration) is deterministic.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpu3dsad_torch.utils import trace


class MultiheadAttention(nn.Module):
    """d channels in `heads` heads (module docstring)."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        if d % heads:
            raise ValueError(f"{heads} heads do not divide {d} channels")
        self.d, self.heads = d, heads
        self.scale = math.sqrt(1.0 / (d // heads))
        self.in_proj = nn.Linear(d, 3 * d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, kv: torch.Tensor | None = None,
                key_padding: torch.Tensor | None = None) -> torch.Tensor:
        """x [B,L,d] the queries' input; kv [B,S,d] the keys' and values'
        input (None: x, self-attention); key_padding [B,S] bool, True at
        keys no query attends to -> [B,L,d]."""
        d = self.d
        w, b = self.in_proj.weight, self.in_proj.bias
        if kv is None:
            q, k, v = F.linear(x, w, b).chunk(3, -1)
        else:
            q = F.linear(x, w[:d], b[:d])
            k, v = F.linear(kv, w[d:], b[d:]).chunk(2, -1)
        B, L, _ = q.shape
        S, h = k.shape[1], self.heads
        q = q.reshape(B, L, h, d // h).transpose(1, 2)
        k = k.reshape(B, S, h, d // h).transpose(1, 2)
        v = v.reshape(B, S, h, d // h).transpose(1, 2)
        scores = torch.matmul(q * self.scale, k.transpose(-1, -2))
        if key_padding is not None:
            scores = scores.masked_fill(key_padding[:, None, None, :],
                                        -torch.inf)
        out = torch.matmul(torch.softmax(scores, -1), v)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, d))


def key_padding(mask: torch.Tensor) -> torch.Tensor:
    """The keys a [B,S] validity mask pads; none in a scene with no valid
    key, whose queries then attend to every key rather than to none (a
    softmax over nothing is NaN, and NaN boxes would reach the batch's NMS
    span)."""
    mask = mask.bool()
    return ~mask & mask.any(-1, keepdim=True)


class DecoderLayer(nn.Module):
    """d channels, `heads` heads, an FFN of `ffn` hidden channels
    (module docstring); LayerNorm's eps is mmcv's and torch's, 1e-5."""

    def __init__(self, d: int, heads: int, ffn: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d, heads)
        self.norm_0 = nn.LayerNorm(d)
        self.cross_attn = MultiheadAttention(d, heads)
        self.norm_1 = nn.LayerNorm(d)
        self.ffn_in = nn.Linear(d, ffn)
        self.ffn_out = nn.Linear(ffn, d)
        self.norm_2 = nn.LayerNorm(d)

    def forward(self, q, k, query_pos, key_pos, padding=None):
        """q [B,L,d] the queries, k [B,S,d] the keys (and values),
        query_pos [B,L,d] and key_pos [B,S,d] their position terms,
        padding [B,S] (key_padding) -> the next queries [B,L,d]."""
        with trace.span("decoder.self_attn"):
            q = self.norm_0(q + self.self_attn(q + query_pos))
        with trace.span("decoder.cross_attn"):
            q = self.norm_1(q + self.cross_attn(q + query_pos, k + key_pos,
                                                padding))
        with trace.span("decoder.ffn"):
            q = self.norm_2(q + self.ffn_out(torch.relu(self.ffn_in(q))))
        return q
