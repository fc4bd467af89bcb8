"""Evaluation: prediction parsing (decode + NMS on the device, per-scene
lists on the host) and average precision."""

from tpu3dsad_torch.eval.ap import APCalculator
from tpu3dsad_torch.eval.parse import (
    parse_groundtruths,
    parse_predictions,
    predictions_to_lists,
)

__all__ = ["APCalculator", "parse_groundtruths", "parse_predictions",
           "predictions_to_lists"]
