"""PyTorch modules: shared MLP, FC head, masked BatchNorm, set abstraction,
GroupAll, feature propagation (tpu3dsad/nn)."""

from tpu3dsad_torch.nn.feature_propagation import FeaturePropagation
from tpu3dsad_torch.nn.mlp import MLPHead, SharedMLP, init_like_flax_
from tpu3dsad_torch.nn.norm import MaskedBatchNorm
from tpu3dsad_torch.nn.set_abstraction import GroupAll, SetAbstraction

__all__ = [
    "FeaturePropagation",
    "GroupAll",
    "MLPHead",
    "MaskedBatchNorm",
    "SetAbstraction",
    "SharedMLP",
    "init_like_flax_",
]
