"""3DSSD, the point-based single-stage detector (Yang, Sun, Liu, Jia,
CVPR 2020, arXiv:2002.10187), at mmdetection3d's KITTI car setting
(configs/3dssd/3dssd_4x4_kitti-3d-car.py; the ModelConfig ssd3d_*
defaults), model.name='ssd3d'.

Backbone, no feature propagation: three MSG set-abstraction levels with
fusion sampling and an aggregation conv each (nn/set_abstraction.py):

  * SA1: D-FPS of 4096 of the scan's points, radii 0.2 / 0.4 / 0.8;
  * SA2: "FS", F-FPS 512 (by xyz and the 64 features) and D-FPS 512 of
    SA1's 4096 points, 1024 centres, F's first;
  * SA3: F-FPS 256 of SA2's first 512 points (its F-FPS centres) by xyz and
    the 128 features, D-FPS 256 of the other 512;

each grouping xyz relative to the centre, not divided by the radius, with
BatchNorm's eps 1e-3. Then:

  * vote: SA3's first 256 points (its F-FPS centres) are the seeds; an MLP
    and a Linear give each an offset, clamped per axis to
    +-ssd3d_vote_range, and vote = seed + offset (the features are kept);
  * candidate generation: an MSG grouping of all SA3 points and features
    around the 256 votes (no sampling), convs with bias, 1536 channels;
  * head: a shared MLP, then a class branch (one logit a class) and a
    regression branch (centre offset 3, size 3, heading bin scores NH,
    normalised heading residuals NH), convs with bias;
  * the anchor-free decode (mmdet3d's AnchorFreeBBoxCoder): centre = vote +
    offset, size = max(2 raw, 0.1), heading = bin * 2 pi / NH + residual of
    the argmax bin * pi / NH, less 2 pi above pi.

Weights are drawn as a fresh flax model's would be (nn/mlp.py), from
`generator` (seed 0 if None). eval/parse.py::parse_ssd3d scores each box by
the sigmoid of its class logit and suppresses by eval.cfg's NMS.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpu3dsad_torch.config import ModelConfig, class_mean_sizes
from tpu3dsad_torch.nn import SetAbstraction
from tpu3dsad_torch.nn.mlp import SharedMLP, init_like_flax_
from tpu3dsad_torch.ops.boxes import angle_from_bin
from tpu3dsad_torch.utils import trace
from tpu3dsad_torch.utils.constants import device_constant

# the spans of the levels, named once (an f-string would allocate per call
# with the tracer off)
_SA_SPANS = ("ssd3d.sa1", "ssd3d.sa2", "ssd3d.sa3")


def level_sampling(cfg: ModelConfig, level: int) -> tuple:
    """((mode, end, picks), ...) of SA level `level` (0-based)."""
    return tuple(zip(cfg.ssd3d_fps_mods[level], cfg.ssd3d_fps_ranges[level],
                     cfg.ssd3d_npoints[level]))


def level_points(cfg: ModelConfig, level: int) -> int:
    """The centres SA level `level` keeps: its samplers' picks."""
    return sum(m * (2 if mode == "FS" else 1)
               for mode, _, m in level_sampling(cfg, level))


class SSD3D(nn.Module):
    """cfg: a ModelConfig with name 'ssd3d'. mean_sizes: kept for the
    serving contract (serving.InferenceProgram), unused by the anchor-free
    decode. The model is built on `device`, the card unless the caller asks
    for the CPU; built for "cuda" where there is no card, it raises.

    In training mode BatchNorm takes the masked batch statistics and
    updates its running averages with `bn_momentum` (calibration; 3DSSD's
    losses are not ported)."""

    def __init__(self, cfg: ModelConfig, mean_sizes=None, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.mean_sizes = (class_mean_sizes(cfg.num_classes)
                           if mean_sizes is None
                           else np.asarray(mean_sizes, np.float32))
        self.point_features = cfg.ssd3d_point_features
        eps = cfg.ssd3d_bn_eps
        ch = cfg.ssd3d_point_features
        self.levels = len(cfg.ssd3d_npoints)
        for i in range(self.levels):
            sa = SetAbstraction(
                level_points(cfg, i), cfg.ssd3d_radii[i],
                cfg.ssd3d_nsamples[i], cfg.ssd3d_mlps[i], in_features=ch,
                sampling=level_sampling(cfg, i),
                aggregation=cfg.ssd3d_aggregation[i], eps=eps)
            self.add_module(f"sa{i + 1}", sa)
            ch = sa.out_channels
        # the seeds: the last level's first sampler's picks
        self.seeds = cfg.ssd3d_npoints[-1][0]
        self.vote = SharedMLP(ch, cfg.ssd3d_vote_channels, eps=eps)
        self.vote_out = nn.Linear(cfg.ssd3d_vote_channels[-1], 3)
        self.vote_range = np.asarray(cfg.ssd3d_vote_range, np.float32)
        self.cg = SetAbstraction(self.seeds, cfg.ssd3d_cg_radii,
                                 cfg.ssd3d_cg_nsamples, cfg.ssd3d_cg_mlps,
                                 in_features=ch, eps=eps, bias=True)
        self.shared = SharedMLP(self.cg.out_channels,
                                cfg.ssd3d_shared_channels, eps=eps, bias=True)
        width = cfg.ssd3d_shared_channels[-1]
        branch = cfg.ssd3d_branch_channels
        self.cls = SharedMLP(width, branch, eps=eps, bias=True)
        self.cls_out = nn.Linear(branch[-1], cfg.num_classes)
        self.reg = SharedMLP(width, branch, eps=eps, bias=True)
        self.reg_out = nn.Linear(branch[-1], 6 + 2 * cfg.num_heading_bins)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_like_flax_(self, generator)
        self.eval()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SSD3D(device='cuda'): no CUDA device is available; pass "
                "device='cpu' to build it on the CPU")
        self.to(device)

    def forward(self, points, features=None, *, mask=None, bn_momentum=0.9):
        """points [B,N,3], features [B,N,ssd3d_point_features] -> end_points:
        the boxes (center, size, heading), the class logits
        (sem_cls_scores), the votes (proposal_xyz) and their mask
        (proposal_mask), the raw heading fields, and each level's picks
        into its input (sa1_inds, ...)."""
        if features is None or features.shape[-1] != self.point_features:
            raise ValueError(
                f"3DSSD takes {self.point_features} point feature channels")
        if mask is None:
            mask = torch.ones(points.shape[:2], dtype=torch.bool,
                              device=points.device)
        end_points = {}
        xyz, feats, m = points, features, mask.bool()
        for i in range(self.levels):
            with trace.span(_SA_SPANS[i]):
                xyz, feats, inds, m = getattr(self, f"sa{i + 1}")(
                    xyz, feats, mask=m, bn_momentum=bn_momentum)
            end_points[f"sa{i + 1}_inds"] = inds
        S = self.seeds
        seed_xyz, seed_mask = xyz[:, :S], m[:, :S]
        with trace.span("ssd3d.vote"):
            h = self.vote(feats[:, :S], mask=seed_mask,
                          bn_momentum=bn_momentum)
            limit = device_constant(self.vote_range, points.device)
            offset = self.vote_out(h).clamp(min=-limit, max=limit)
            votes = seed_xyz + offset
        with trace.span("ssd3d.cg"):
            cand = self.cg.group_at(xyz, feats, votes, mask=m,
                                    center_mask=seed_mask,
                                    bn_momentum=bn_momentum)
        with trace.span("ssd3d.head"):
            h = self.shared(cand, mask=seed_mask, bn_momentum=bn_momentum)
            logits = self.cls_out(self.cls(h, mask=seed_mask,
                                           bn_momentum=bn_momentum))
            raw = self.reg_out(self.reg(h, mask=seed_mask,
                                        bn_momentum=bn_momentum))
            end_points.update(decode(raw, votes, self.cfg.num_heading_bins))
        end_points.update(proposal_xyz=votes, proposal_mask=seed_mask,
                          vote_offset=offset, sem_cls_scores=logits)
        return end_points


def decode(raw, votes, num_heading_bins: int) -> dict:
    """The anchor-free decode of raw [B,P,6 + 2 NH] at the votes [B,P,3]
    (module docstring): center, size, heading, heading_scores,
    heading_residuals."""
    NH = num_heading_bins
    hscores = raw[..., 6:6 + NH]
    hres = raw[..., 6 + NH:6 + 2 * NH] * (np.pi / NH)
    hcls = hscores.argmax(-1)
    res = hres.gather(-1, hcls[..., None])[..., 0]
    return {"center": votes + raw[..., :3],
            "size": (raw[..., 3:6] * 2).clamp_min(0.1),
            "heading": angle_from_bin(hcls, res, NH),
            "heading_scores": hscores,
            "heading_residuals": hres}
