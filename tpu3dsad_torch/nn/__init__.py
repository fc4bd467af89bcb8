"""PyTorch modules: shared MLP, masked BatchNorm, set abstraction, feature
propagation (tpu3dsad/nn)."""

from tpu3dsad_torch.nn.feature_propagation import FeaturePropagation
from tpu3dsad_torch.nn.mlp import SharedMLP, init_like_flax_
from tpu3dsad_torch.nn.norm import MaskedBatchNorm
from tpu3dsad_torch.nn.set_abstraction import SetAbstraction

__all__ = [
    "FeaturePropagation",
    "MaskedBatchNorm",
    "SetAbstraction",
    "SharedMLP",
    "init_like_flax_",
]
