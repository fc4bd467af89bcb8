"""Host batching of numpy scene dicts (tpu3dsad/data/pipeline.py:36-46
and :165-188): box padding and the full-coverage val sweep. Batcher (the
prefetch thread) waits for ROADMAP A7.5.
"""

from __future__ import annotations

import numpy as np


def pad_boxes(arr: np.ndarray, max_boxes: int):
    """Pad a per-box array [G, ...] to [max_boxes, ...] (truncating past
    it); returns (arr, mask)."""
    g = arr.shape[0]
    if g > max_boxes:
        arr, g = arr[:max_boxes], max_boxes
    out = np.zeros((max_boxes,) + arr.shape[1:], arr.dtype)
    out[:g] = arr
    mask = np.zeros(max_boxes, bool)
    mask[:g] = True
    return out, mask


def iter_val_batches(items, load_fn, batch_size: int):
    """Every item once with scene_mask=True; the tail batch is filled with
    repeats of its first loaded scene under scene_mask=False, so every
    batch has the same shape and no scene is scored twice."""
    n = len(items)
    for i in range(0, n, batch_size):
        idx = range(i, min(i + batch_size, n))
        mask = np.zeros(batch_size, bool)
        mask[:len(idx)] = True
        loaded = [load_fn(items[k]) for k in idx]
        loaded += [loaded[0]] * (batch_size - len(loaded))
        batch = {k: np.stack([it[k] for it in loaded]) for k in loaded[0]}
        batch["scene_mask"] = mask
        yield batch
