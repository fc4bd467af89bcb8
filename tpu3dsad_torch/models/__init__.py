"""Model assemblies: detection backbone, voting, size-adaptive proposal
head, decode, and the full detector (tpu3dsad/models)."""

from tpu3dsad_torch.models.backbone import PointNet2Backbone
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector

__all__ = ["PointNet2Backbone", "SizeAdaptiveDetector"]
