"""PointNet++ classifiers, SSG and MSG — benchmark config #1
(tpu3dsad/models/classifier.py).

SSG: SA(512, r=0.2, K=32, [64,64,128]) -> SA(128, r=0.4, K=64,
[128,128,256]) -> GroupAll([256,512,1024]) -> FC head. MSG
(model.classifier_msg=true, the lineage's pointnet2_cls_msg): each SA
level groups at three radii and concatenates the pooled features.
"""

from __future__ import annotations

import torch
from torch import nn

from tpu3dsad_torch.nn.mlp import MLPHead, init_like_flax_
from tpu3dsad_torch.nn.set_abstraction import GroupAll, SetAbstraction

SSG_SA1 = dict(radii=(0.2,), nsamples=(32,), mlps=((64, 64, 128),))
SSG_SA2 = dict(radii=(0.4,), nsamples=(64,), mlps=((128, 128, 256),))
MSG_SA1 = dict(radii=(0.1, 0.2, 0.4), nsamples=(16, 32, 128),
               mlps=((32, 32, 64), (64, 64, 128), (64, 96, 128)))
MSG_SA2 = dict(radii=(0.2, 0.4, 0.8), nsamples=(32, 64, 128),
               mlps=((64, 64, 128), (128, 128, 256), (128, 128, 256)))


def build_classifier(cfg, num_classes: int, *, device="cuda",
                     generator: torch.Generator | None = None
                     ) -> "PointNet2Classifier":
    """The classifier of cfg (a Config), weights drawn from `generator`
    (else cfg.train.seed). The one place the sampling schedule derived
    from the point budget lives, so training and evaluation build the same
    architecture."""
    n = cfg.data.num_points
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    return PointNet2Classifier(
        num_classes=num_classes, dropout=cfg.model.dropout,
        sa1_npoint=min(512, n // 2), sa2_npoint=min(128, n // 8),
        msg=cfg.model.classifier_msg, device=device, generator=generator)


class PointNet2Classifier(nn.Module):
    """xyz [B,N,3] (+ mask [B,N]) -> logits [B, num_classes]. Weights are
    drawn as a fresh flax model's would be, from `generator` (a CPU
    torch.Generator; seed 0 if None), then the module is moved to
    `device`: the card unless the caller asks for the CPU. Built for
    "cuda" where there is no card, it raises. The reference's per-point
    input features have no caller and are not ported.

    In training mode (`model.train()`), BatchNorm uses the masked batch
    statistics and updates its running averages with `bn_momentum`, and
    the head's dropout draws from the `generator` given to forward."""

    def __init__(self, num_classes: int = 40, dropout: float = 0.5,
                 sa1_npoint: int = 512, sa2_npoint: int = 128,
                 msg: bool = False, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        sa1, sa2 = (MSG_SA1, MSG_SA2) if msg else (SSG_SA1, SSG_SA2)
        self.sa1 = SetAbstraction(sa1_npoint, **sa1)
        self.sa2 = SetAbstraction(sa2_npoint,
                                  in_features=self.sa1.out_channels, **sa2)
        self.sa3 = GroupAll((256, 512, 1024),
                            in_features=self.sa2.out_channels)
        self.head = MLPHead(self.sa3.out_channels, (512, 256), num_classes,
                            dropout=dropout)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_like_flax_(self, generator)
        self.eval()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PointNet2Classifier(device='cuda'): no CUDA device is "
                "available; pass device='cpu' to build it on the CPU")
        self.to(device)

    def forward(self, xyz, *, mask=None, bn_momentum=0.9,
                generator: torch.Generator | None = None):
        xyz, feats, _, mask = self.sa1(xyz, mask=mask,
                                       bn_momentum=bn_momentum)
        xyz, feats, _, mask = self.sa2(xyz, feats, mask=mask,
                                       bn_momentum=bn_momentum)
        global_feat = self.sa3(xyz, feats, mask=mask,
                               bn_momentum=bn_momentum)
        return self.head(global_feat, bn_momentum=bn_momentum,
                         generator=generator)
