"""Evaluation: on-device prediction parsing (decode + NMS)."""

from tpu3dsad_torch.eval.parse import parse_predictions

__all__ = ["parse_predictions"]
