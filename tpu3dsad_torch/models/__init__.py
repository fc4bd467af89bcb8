"""Model assemblies: detection backbone, voting, size-adaptive proposal
head, decode, the full detector, and the PointNet++ classifier
(tpu3dsad/models)."""

from tpu3dsad_torch.models.backbone import PointNet2Backbone
from tpu3dsad_torch.models.classifier import (
    PointNet2Classifier,
    build_classifier,
)
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector

__all__ = ["PointNet2Backbone", "PointNet2Classifier", "SizeAdaptiveDetector",
           "build_classifier"]
