"""Group-Free 3D (Liu, Zhang, Cao, Hu, Tong, "Group-Free 3D Object
Detection via Transformers", ICCV 2021, arXiv:2104.00678) at
mmdetection3d's ScanNet L12-O256 setting
(configs/groupfree3d/groupfree3d_head-L12-O256_4xb8_scannet-seg.py; the
ModelConfig groupfree_* defaults and preset=groupfree3d),
model.name='groupfree3d'.

The backbone is the detector's PointNet++ (models/backbone.py) over xyz
alone, its FP2 as wide as the decoder (d = 288): seeds S [B,1024,3], F
[B,1024,d]. Every "Linear + BN + ReLU" below is a Linear with bias and
MaskedBatchNorm(relu=True), so eval mode takes the bn_relu kernel. Then:

  * KPS: s = Linear(d, 1)(two Linear(d, d) + BN + ReLU of F); invalid
    seeds at -inf; the groupfree_candidates seeds of largest s, in that
    order (a stable sort: ties to the lower seed) are the candidates
    X = S[idx], G = F[idx]. mmdet3d ranks by sigmoid(s), the same order
    but where fp32's sigmoid ties logits above ~17 at 1.0;
  * the proposal stage: the box head H on G, decoded at X: box_0;
  * q = Linear(G), k = Linear(F), both with bias;
  * decoder layer i = 0..L-1 (nn/transformer.py::DecoderLayer, post-norm,
    padded seeds masked out of the cross-attention's keys) with the query
    position term PE_q,i([center, size] of box_i) and the key position term
    PE_k,i(S), then the stage's box head H_i on the queries: box_{i+1};
  * a position embedding PE(in) is Linear(in, d) + BN + ReLU, then
    Linear(d, d) with bias;
  * a box head H is two Linear(d, d) + BN + ReLU, then `cls_out` (d ->
    1 + NC: objectness, then the classes) and `reg_out` (d -> 3 + 2 +
    4 NC: centre residual 3 | heading class 1 | heading residual 1 | size
    class NC | normalised size residuals NC x 3);
  * the decode (mmdet3d's GroupFree3DBBoxCoder, one heading bin, no
    rotation): center = X + residual, at every stage relative to the
    candidates; c = the argmax size class; size = mean[c] + res[c] *
    mean[c]; heading 0.

The published dropouts (attention, projection and FFN, 0.1 each) are the
identity at inference and are not held: a train-mode forward, which only
calibrates BatchNorm here, is deterministic. Group-Free's losses are not
ported (the train entry refuses model.name=groupfree3d).

Weights are drawn as a fresh flax model's would be (nn/mlp.py), from
`generator` (seed 0 if None). eval/parse.py::parse_groupfree takes the
boxes of the last groupfree_stages stages, keeps those with more than
groupfree_min_points input points in them (the box point-count kernel)
and suppresses by class-aware axis-aligned 3D NMS.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpu3dsad_torch import ops
from tpu3dsad_torch.config import ModelConfig, class_mean_sizes
from tpu3dsad_torch.models.backbone import PointNet2Backbone
from tpu3dsad_torch.nn.mlp import SharedMLP, init_like_flax_
from tpu3dsad_torch.nn.transformer import DecoderLayer, key_padding
from tpu3dsad_torch.utils import trace
from tpu3dsad_torch.utils.constants import device_constant


class PositionEmbedding(nn.Module):
    """PE(in): Linear(in, d) + BN + ReLU, then Linear(d, d) with bias."""

    def __init__(self, in_channels: int, d: int):
        super().__init__()
        self.mlp = SharedMLP(in_channels, (d,), bias=True)
        self.out = nn.Linear(d, d)

    def forward(self, x, mask, bn_momentum=0.9):
        return self.out(self.mlp(x, mask=mask, bn_momentum=bn_momentum))


class BoxHead(nn.Module):
    """H: the shared Linear + BN + ReLU of `channels`, then the class
    logits (cls_out: objectness, then num_classes) and the box fields
    (reg_out: 5 + 4 num_classes)."""

    def __init__(self, d: int, channels, num_classes: int):
        super().__init__()
        self.shared = SharedMLP(d, channels, bias=True)
        self.cls_out = nn.Linear(channels[-1], 1 + num_classes)
        self.reg_out = nn.Linear(channels[-1], 5 + 4 * num_classes)

    def forward(self, x, mask, bn_momentum=0.9):
        h = self.shared(x, mask=mask, bn_momentum=bn_momentum)
        return self.cls_out(h), self.reg_out(h)


def decode(cls, reg, base_xyz, mean_sizes):
    """One stage's boxes (module docstring): (center [B,P,3], size [B,P,3],
    objectness logit [B,P], class logits [B,P,NC]) of cls [B,P,1+NC] and
    reg [B,P,5+4NC] at the candidates base_xyz [B,P,3]; mean_sizes [NC,3]
    on their device."""
    NS = mean_sizes.shape[0]
    sc = reg[..., 5:5 + NS].argmax(-1)
    res = reg[..., 5 + NS:5 + 4 * NS].reshape(*reg.shape[:-1], NS, 3) \
        * mean_sizes
    res = res.gather(-2, sc[..., None, None].expand(*sc.shape, 1, 3))
    return (base_xyz + reg[..., :3], mean_sizes[sc] + res[..., 0, :],
            cls[..., 0], cls[..., 1:])


class GroupFree3D(nn.Module):
    """cfg: a ModelConfig with name 'groupfree3d'. mean_sizes [NC,3]: the
    size priors of the decode, else the synthetic ones. The model is built
    on `device`, the card unless the caller asks for the CPU; built for
    "cuda" where there is no card, it raises.

    In training mode BatchNorm takes the masked batch statistics and
    updates its running averages with `bn_momentum` (calibration; the
    losses are not ported)."""

    def __init__(self, cfg: ModelConfig, mean_sizes=None, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.mean_sizes = (class_mean_sizes(cfg.num_classes)
                           if mean_sizes is None
                           else np.asarray(mean_sizes, np.float32))
        if len(self.mean_sizes) != cfg.num_classes:
            raise ValueError(f"{len(self.mean_sizes)} mean sizes for "
                             f"{cfg.num_classes} classes")
        if cfg.append_height:
            raise ValueError("Group-Free 3D reads xyz alone: set "
                             "model.append_height=false")
        d = cfg.fp_channels[1][-1]
        self.candidates = cfg.groupfree_candidates
        self.backbone = PointNet2Backbone(cfg, 0)
        self.kps = SharedMLP(d, (d, d), bias=True)
        self.kps_out = nn.Linear(d, 1)
        heads = cfg.groupfree_head_channels
        self.proposal = BoxHead(d, heads, cfg.num_classes)
        self.query_proj = nn.Linear(d, d)
        self.key_proj = nn.Linear(d, d)
        L = cfg.groupfree_layers
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(d, cfg.groupfree_heads, cfg.groupfree_ffn)
            for _ in range(L))
        self.query_posembeds = nn.ModuleList(
            PositionEmbedding(6, d) for _ in range(L))
        self.key_posembeds = nn.ModuleList(
            PositionEmbedding(3, d) for _ in range(L))
        self.prediction_heads = nn.ModuleList(
            BoxHead(d, heads, cfg.num_classes) for _ in range(L))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_like_flax_(self, generator)
        self.eval()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "GroupFree3D(device='cuda'): no CUDA device is available; "
                "pass device='cpu' to build it on the CPU")
        self.to(device)

    def forward(self, points, features=None, *, mask=None, bn_momentum=0.9):
        """points [B,N,3] (features: none; Group-Free reads xyz) ->
        end_points: the seeds (seed_xyz, seed_mask), the KPS logits
        (kps_logits [B,S]) and picks (candidate_inds [B,P] int64), the
        candidates (candidate_xyz, proposal_mask [B,P]), every stage's boxes
        stacked, the proposal stage first (stage_center and stage_size
        [B,L+1,P,3], stage_obj [B,L+1,P], stage_sem [B,L+1,P,NC]), and the
        input (points, point_mask) for the parse's point count."""
        if features is not None and features.shape[-1]:
            raise ValueError("Group-Free 3D takes no point features")
        if mask is None:
            mask = torch.ones(points.shape[:2], dtype=torch.bool,
                              device=points.device)
        mask = mask.bool()
        bn = bn_momentum
        with trace.span("groupfree.backbone"):
            bb = self.backbone(points, None, mask=mask, bn_momentum=bn)
        seed_xyz, seeds = bb["seed_xyz"], bb["seed_features"]
        seed_mask = bb["seed_mask"].bool()
        with trace.span("groupfree.kps"):
            h = self.kps(seeds, mask=seed_mask, bn_momentum=bn)
            logits = self.kps_out(h)[..., 0]
            ranked = torch.where(seed_mask, logits, -torch.inf)
            idx = torch.sort(ranked, dim=-1, descending=True,
                             stable=True)[1][:, :self.candidates]
            cand_xyz = ops.gather(seed_xyz, idx)
            cand = ops.gather(seeds, idx)
            cmask = seed_mask.gather(1, idx)
        sizes = device_constant(self.mean_sizes, points.device)
        with trace.span("groupfree.proposal"):
            box = decode(*self.proposal(cand, cmask, bn), cand_xyz, sizes)
            q = self.query_proj(cand)
            k = self.key_proj(seeds)
        boxes = [box]
        padding = key_padding(seed_mask)
        with trace.span("groupfree.decoder"):
            for i, layer in enumerate(self.decoder_layers):
                with trace.span("decoder.posembed"):
                    qp = self.query_posembeds[i](
                        torch.cat([box[0], box[1]], -1), cmask, bn)
                    kp = self.key_posembeds[i](seed_xyz, seed_mask, bn)
                q = layer(q, k, qp, kp, padding)
                with trace.span("decoder.head"):
                    box = decode(*self.prediction_heads[i](q, cmask, bn),
                                 cand_xyz, sizes)
                boxes.append(box)
        center, size, obj, sem = (torch.stack(parts, 1)
                                  for parts in zip(*boxes))
        return {"seed_xyz": seed_xyz, "seed_mask": seed_mask,
                "kps_logits": logits, "candidate_inds": idx,
                "candidate_xyz": cand_xyz, "proposal_mask": cmask,
                "stage_center": center, "stage_size": size,
                "stage_obj": obj, "stage_sem": sem,
                "points": points, "point_mask": mask}
