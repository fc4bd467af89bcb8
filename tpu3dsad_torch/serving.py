"""The whole-scene inference program as a server's unit of work
(tpu3dsad/serving.py:35-67, build_inference_fn).

One call is forward + box decode + class-aware 3D NMS over a fixed-shape
batch, returning the parsed prediction fields with the post-NMS keep mask.
Exporting the program (the reference's jax.export artifact) waits for
torch.export (ROADMAP A10).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dsad_torch.eval.parse import parse_predictions

_EXPORT_KEYS = ("center", "size", "heading", "sem_cls", "obj_prob", "keep")


def build_inference_fn(cfg, model, mean_sizes):
    """fn(points [B,N,3], mask [B,N]) -> {key: tensor} for _EXPORT_KEYS.

    cfg: a Config (cfg.model, cfg.eval); model: a
    SizeAdaptiveDetector built from cfg.model with the same mean_sizes."""
    mean_sizes = np.asarray(mean_sizes, np.float32)
    if not np.array_equal(mean_sizes, model.mean_sizes):
        raise ValueError("model was built with other mean_sizes")
    model.eval()

    @torch.inference_mode()
    def infer(points, mask):
        ep = model(points, mask=mask)
        parsed = parse_predictions(ep, mean_sizes, cfg.model.num_heading_bins,
                                   cfg.eval)
        return {k: parsed[k] for k in _EXPORT_KEYS}

    return infer
