"""Host input pipeline in numpy (tpu3dsad/data/pipeline.py): padding, vote
targets, the full-coverage val sweep and the prefetch thread.

Every batch is fixed-shape (points padded or subsampled to the config's
budget, GT boxes padded to max_boxes), so one set of kernel shapes serves
the whole epoch. For one generator state every function draws and
computes exactly what the reference does.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Callable, Iterator

import numpy as np


def pad_points(points: np.ndarray, budget: int, rng=None):
    """Pad [N,C] to [budget,C] with zero rows (the mask marks them), or
    subsample to the budget where N is larger (the first `budget` rows
    without `rng`). Returns (points, mask, sel): sel indexes each kept row
    in the input, for subsetting per-point labels."""
    n = points.shape[0]
    if n >= budget:
        sel = (np.arange(budget) if rng is None
               else rng.choice(n, budget, replace=False))
        return points[sel], np.ones(budget, bool), sel
    pad = np.zeros((budget - n, points.shape[1]), points.dtype)
    mask = np.concatenate([np.ones(n, bool), np.zeros(budget - n, bool)])
    return np.concatenate([points, pad]), mask, np.arange(n)


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


def candidate_votes(points, votes, vmask, owner, centers, sizes, headings,
                    V: int):
    """Single-owner votes [N,3] -> V candidates [N,V,3] (the vote loss
    takes the min over them).

    Slot 0 keeps the primary offset; slots 1..V-1 take the OTHER boxes
    that contain the point under oriented containment, in box-index order;
    unused slots copy the primary offset (a zero slot would reward votes
    that stay at the seed). `owner` [N] is the primary box of each point
    (-1 for none)."""
    out = np.repeat(votes[:, None, :], V, axis=1)  # [N,V,3]
    if V <= 1 or not len(centers) or not vmask.any():
        return out
    vp = np.nonzero(vmask)[0]
    # separate [n,G] planes, no [n,G,3] stack: ~3x cheaper on the host
    p = points[vp]
    rx = p[:, 0:1] - centers[None, :, 0]  # [n,G]
    ry = p[:, 1:2] - centers[None, :, 1]
    rz = p[:, 2:3] - centers[None, :, 2]
    ch, sh = np.cos(headings)[None, :], np.sin(headings)[None, :]
    half = sizes / 2 + 1e-6
    inside = (
        (np.abs(ch * rx + sh * ry) <= half[None, :, 0])
        & (np.abs(-sh * rx + ch * ry) <= half[None, :, 1])
        & (np.abs(rz) <= half[None, :, 2])
    )  # [n,G]
    inside[np.arange(len(vp)), owner[vp]] = False  # never repeat the owner
    # slot work only for the few points inside ANOTHER box
    rows = np.nonzero(inside.any(axis=1))[0]
    if not len(rows):
        return out
    ins = inside[rows]
    # the first V-1 other containing boxes, in box-index order (fewer boxes
    # than slots leaves the tail at the primary copy)
    order = np.argsort(~ins, axis=1, kind="stable")[:, : V - 1]
    kslots = order.shape[1]
    valid_c = np.take_along_axis(ins, order, axis=1)
    off = centers[order] - p[rows][:, None, :]  # [r,k,3]
    sel = vp[rows]
    out[sel, 1 : 1 + kslots] = np.where(valid_c[..., None], off,
                                        out[sel, :1])
    return out


def recover_owner(points, votes, vmask, centers):
    """The primary owner of each point from single-owner votes: the box
    whose center the vote points at (exact for votes aimed at a center, as
    the loaders make them). [N] int64, -1 for points that do not vote."""
    owner = np.full(len(points), -1, np.int64)
    if vmask.any() and len(centers):
        tgt = points[vmask] + votes[vmask]
        owner[vmask] = np.argmin(
            np.sum((tgt[:, None, :] - centers[None]) ** 2, -1), axis=1)
    return owner


def compact_owner(owner, max_boxes: int) -> np.ndarray:
    """Check and pack a primary-owner vector into the int8 field of the
    compact-votes format (data.compact_votes), which the train step
    decodes (device_pipeline.decode_compact_votes)."""
    if max_boxes > 127:
        raise ValueError(
            "data.compact_votes packs owners as int8 — "
            f"data.max_boxes={max_boxes} exceeds 127")
    # the owner of a box that pad_boxes dropped has no index: mask its
    # points out of vote supervision
    return np.where(owner >= max_boxes, -1, owner).astype(np.int8)


def scene_to_training_dict(points, spec, owner, max_boxes: int,
                           vote_candidates: int = 1):
    """The padded training example of one detection scene: every point of
    an object votes for its center, other points do not vote; with
    vote_candidates V > 1 the targets are [N,V,3] (candidate_votes)."""
    n = points.shape[0]
    votes = np.zeros((n, 3), np.float32)
    vote_mask = owner >= 0
    votes[vote_mask] = spec.centers[owner[vote_mask]] - points[vote_mask]
    if vote_candidates > 1:
        votes = candidate_votes(points, votes, vote_mask, owner,
                                spec.centers, spec.sizes, spec.headings,
                                vote_candidates)

    centers, box_mask = pad_boxes(spec.centers, max_boxes)
    sizes, _ = pad_boxes(spec.sizes, max_boxes)
    headings, _ = pad_boxes(spec.headings, max_boxes)
    classes, _ = pad_boxes(spec.classes, max_boxes)
    return {
        "points": points.astype(np.float32),
        "point_mask": np.ones(n, bool),
        "vote_targets": votes,
        "vote_mask": vote_mask,
        "gt_centers": centers.astype(np.float32),
        "gt_sizes": sizes.astype(np.float32),
        "gt_headings": headings.astype(np.float32),
        "gt_classes": classes.astype(np.int32),
        "gt_mask": box_mask,
    }


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


class Batcher:
    """Iterator over numpy batch dicts made ahead by one background thread:
    make_batch(rng) with one np.random.Generator of `seed`, so the stream
    for a seed is the reference's. At most `prefetch` batches wait; a
    loader exception is raised in the consumer; `num_batches` ends the
    stream. close() stops the thread and waits for it."""

    def __init__(self, make_batch: Callable[[np.random.Generator], dict],
                 seed: int = 0, prefetch: int = 2,
                 num_batches: int | None = None):
        self._make = make_batch
        self._rng = np.random.default_rng(seed)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._num = num_batches
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        """Queue `item` unless close() comes first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def _worker(self):
        produced = 0
        while not self._stop.is_set():
            if self._num is not None and produced >= self._num:
                self._put(None)
                return
            try:
                batch = self._make(self._rng)
            except BaseException as e:  # raised again in the consumer
                self._put(e)
                return
            produced += 1
            self._put(batch)

    def __iter__(self) -> Iterator[dict]:
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self) -> None:
        """Stop the thread; wait (up to a minute) for the batch it is
        making."""
        self._stop.set()
        self._thread.join(60.0)
