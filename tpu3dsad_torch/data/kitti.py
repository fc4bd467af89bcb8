"""KITTI-style outdoor dataset, benchmark config #4 (tpu3dsad/data/kitti.py):
~120k-point LiDAR scenes cropped to the front range box and sampled down
to the point budget (16384) by FPS.

On-disk contract under `<root>/<split>/`:

  <idx>_pc.npy    float32 [N, 4]  xyz + intensity (velodyne frame, Z-up)
  <idx>_bbox.npy  float32 [G, 8]  cx cy cz dx dy dz heading cls (cls 0..2:
                                  car, pedestrian, cyclist)

Per scene: crop -> FPS to the budget -> pad -> (train batches, with
data.augment) flip / rotation / scale by the "kitti" recipe -> vote
targets, as [N,V,3] offsets or, with data.compact_votes, as int8 owners
that the train step decodes. The FPS runs on the card (`device_fps`,
data.device_preproc=true: one cloud of ~120k points, the cluster kernel
B2) or as the plain version on the CPU (`host_fps`). Its picks are cached
next to the scene as `<idx>_fpscache_<n>.npy`, row 0 holding the cropped
count, the reference's format.

`fit_scene` is the fit of a raw scan (crop -> FPS -> gather -> pad) kept
on one device, which a server runs on each new scan
(serving.prepare_scene_batch for a KITTI artifact). Its FPS is `fit_fps`,
which the loader's `device_fps` runs on the cloud it cropped, so both
take the same picks from the same kernel.

On the card each fit runs on a side stream of its own, from a pool of as
many streams as the card runs B2 clusters at once (ops/cuda/fps.py::
flat_clusters), taken in turn. A fit waits for its input's ready point,
not for the tail of the caller's stream: the scans of one batch are views
of one tensor, ready as soon as its first scan was, so while nothing has
written to that tensor since (its version counter unchanged) a fit of a
later view waits on the event its first fit recorded, and the batch's B2
launches overlap. The caller's stream then waits for the side stream, and
the fit's tensors are marked as used there. `fits` counts the fits on the
card and `fits_shared` those that waited on a shared ready point.
"""

from __future__ import annotations

import itertools
import os
import weakref
from glob import glob
from typing import NamedTuple

import numpy as np
import torch

from tpu3dsad_torch import ops
from tpu3dsad_torch.data import host
from tpu3dsad_torch.data.augment import augment_scene, resolve_aug
from tpu3dsad_torch.data.pipeline import (
    compact_owner,
    iter_val_batches,
    pad_boxes,
    recover_owner,
)
from tpu3dsad_torch.ops.cuda import fps as cuda_fps
from tpu3dsad_torch.utils import trace
from tpu3dsad_torch.utils.constants import device_constant

KITTI_CLASS_NAMES = ("car", "pedestrian", "cyclist")
KITTI_MEAN_SIZES = np.array(
    [[3.88, 1.63, 1.53], [0.84, 0.66, 1.74], [1.76, 0.60, 1.73]], np.float32
)
# front-camera range crop (meters): x forward, y lateral, z up
RANGE_MIN = np.array([0.0, -40.0, -3.0], np.float32)
RANGE_MAX = np.array([70.4, 40.0, 1.0], np.float32)


def range_crop(points: np.ndarray) -> np.ndarray:
    """Indices of the points inside the front range box."""
    return host.range_crop(points, RANGE_MIN, RANGE_MAX)


def host_fps(points: np.ndarray, m: int) -> np.ndarray:
    """FPS of m of the points on the CPU (the plain version; seed 0, ties
    to the lowest index, as ops.furthest_point_sample)."""
    n = points.shape[0]
    if n <= m:
        return np.arange(n)
    xyz = torch.from_numpy(np.ascontiguousarray(points[:, :3], np.float32))
    return ops.furthest_point_sample(xyz[None], m)[0].numpy()


class Fit(NamedTuple):
    """A raw scan fitted to the program's calling convention (fit_scene)."""

    points: torch.Tensor  # [budget, 3] float32, zero rows after the fit
    mask: torch.Tensor  # [budget] bool, False on the padding
    rows: torch.Tensor  # [n] int64: the raw scan's row of each fitted point
    picks: torch.Tensor | None  # [budget] int32 FPS picks into the cropped
    # cloud; None where the crop kept no more than `budget` points


def fit_fps(xyz: torch.Tensor, budget: int, bucket: int = 4096
            ) -> torch.Tensor:
    """FPS of `budget` of the (cropped) points xyz [n, 3] on their device:
    picks [budget] int32, seeded at the first point, as the loader
    samples. The cloud is padded to a multiple of `bucket` under a mask,
    as the reference pads it, so one of more than 65536 points runs the
    cluster kernel (B2)."""
    n = xyz.shape[0]
    padded = -(-n // bucket) * bucket
    cloud = xyz.new_zeros(1, padded, 3)
    cloud[0, :n] = xyz
    valid = (torch.arange(padded, device=xyz.device) < n)[None]
    return ops.furthest_point_sample(cloud, budget, mask=valid)[0]


fits = 0
fits_shared = 0


class Ready(NamedTuple):
    """A batch's ready point: the event that the first fit of a view of
    `base` at `version` recorded on the caller's `stream`."""

    base: weakref.ref
    version: int
    stream: torch.cuda.Stream
    event: torch.cuda.Event


_ready: Ready | None = None
_sides: dict = {}  # device -> (its side streams, the turn)


def shares_ready_point(slot: Ready | None, base, version: int | None,
                       stream) -> bool:
    """Whether a fit of a view of `base` (None where the scan is no view of
    a tensor on the card) at `version`, called on `stream`, may wait on
    `slot`'s event: the same base, still alive, at the same version, on the
    same caller's stream."""
    return (slot is not None and base is not None and slot.base() is base
            and slot.version == version and slot.stream == stream)


def _side_stream(device: torch.device, rows: int,
                 bucket: int) -> torch.cuda.Stream:
    """The next of `device`'s side streams, the pool made at its first fit
    as large as the B2 clusters the card runs at once for that scan's rows
    padded to the bucket (the largest cloud its crop can leave)."""
    if device not in _sides:
        k = cuda_fps.flat_clusters(-(-rows // bucket) * bucket, device)
        _sides[device] = ([torch.cuda.Stream(device) for _ in range(k)],
                          itertools.count())
    streams, turn = _sides[device]
    return streams[next(turn) % len(streams)]


def fit_scene(points, budget: int, device="cuda", *,
              bucket: int = 4096) -> Fit:
    """Fit one raw scan [N, 3+] (an array, or a tensor already on `device`)
    to `budget` points on `device`, the card unless the caller asks for the
    CPU: the range crop, fit_fps of `budget` of the cropped points, the
    gather and the pad to `budget` under a False mask. Everything stays on
    the device: the crop reads its count back (the shape of what follows),
    no pick goes to the host. On the card the fit runs on a side stream
    from its input's ready point (module docstring); the caller's stream
    waits for it, the host does not."""
    global fits, fits_shared, _ready
    device = torch.device(device)
    if device.type != "cuda":
        return _fit(points, budget, device, bucket)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    caller = torch.cuda.current_stream(device)
    base = (points._base if isinstance(points, torch.Tensor)
            and points.device == device else None)
    version = None if base is None else base._version
    if shares_ready_point(_ready, base, version, caller):
        ready = _ready.event
        fits_shared += 1
    else:
        ready = torch.cuda.Event()
        ready.record(caller)
        if base is not None:
            _ready = Ready(weakref.ref(base), version, caller, ready)
    fits += 1
    side = _side_stream(device, len(points), bucket)
    side.wait_event(ready)
    with torch.cuda.stream(side):
        fit = _fit(points, budget, device, bucket)
    caller.wait_stream(side)
    for t in fit:
        if t is not None:
            t.record_stream(caller)
    return fit


def _fit(points, budget: int, device, bucket: int) -> Fit:
    """fit_scene's work on the current stream of `device`."""
    with trace.span("data.fit"):
        scan = torch.as_tensor(points).to(device)
        xyz = scan[:, :3].float()
        with trace.span("fit.crop"):
            lo = device_constant(RANGE_MIN, xyz.device)
            hi = device_constant(RANGE_MAX, xyz.device)
            rows = ((xyz >= lo) & (xyz <= hi)).all(-1).nonzero()[:, 0]
        picks = None
        if rows.shape[0] > budget:
            with trace.span("fit.fps"):
                picks = fit_fps(xyz[rows], budget, bucket)
            rows = rows[picks.long()]
        k = rows.shape[0]
        out = xyz.new_zeros(budget, 3)
        out[:k] = xyz[rows]
        mask = torch.arange(budget, device=xyz.device) < k
        return Fit(out, mask, rows, picks)


def device_fps(points: np.ndarray, m: int, bucket: int = 4096, *,
               device="cuda") -> np.ndarray:
    """FPS of m of the (already cropped) points on `device`, the card
    unless the caller asks for the CPU: fit_scene's FPS (fit_fps), the
    picks brought back for the loader's host gather and cache."""
    xyz = torch.from_numpy(np.ascontiguousarray(points[:, :3], np.float32))
    return fit_fps(xyz.to(device), m, bucket).cpu().numpy()


class KittiDetectionDataset:
    num_classes = len(KITTI_CLASS_NAMES)
    class_names = KITTI_CLASS_NAMES
    mean_sizes = KITTI_MEAN_SIZES

    def __init__(self, cfg, *, device="cuda"):
        """cfg: a Config. `device` runs the FPS when data.device_preproc
        is set: the card unless the caller asks for the CPU."""
        self.cfg = cfg
        self.device = device
        self.root = cfg.data.root
        if not self.root or not os.path.isdir(self.root):
            raise FileNotFoundError(
                f"data.root={self.root!r} not found — point it at the "
                "extracted KITTI .npy directory (see module docstring)")
        self.train_items = self._items("train")
        self.val_items = self._items("val")

    def _items(self, split):
        d = os.path.join(self.root, split)
        idxs = sorted(os.path.basename(p)[: -len("_pc.npy")]
                      for p in glob(os.path.join(d, "*_pc.npy")))
        return [(d, i) for i in idxs]

    def steps_per_epoch(self, batch_size: int) -> int:
        return max(1, len(self.train_items) // batch_size)

    def _fps(self, points: np.ndarray, m: int) -> np.ndarray:
        if self.cfg.data.device_preproc:
            return device_fps(points, m, device=self.device)
        return host_fps(points, m)

    def _load_scene(self, d, idx, rng, augment):
        pc = np.load(os.path.join(d, f"{idx}_pc.npy"))
        bboxes = np.load(os.path.join(d, f"{idx}_bbox.npy")).reshape(-1, 8)
        centers = bboxes[:, :3].astype(np.float32)
        sizes = bboxes[:, 3:6].astype(np.float32)
        headings = bboxes[:, 6].astype(np.float32)
        classes = bboxes[:, 7].astype(np.int32)

        # crop -> FPS -> pad; the picks are cached next to the scene (row 0
        # holds the cropped count, so a scene cropped anew is not served
        # stale picks); a read-only root skips the cache
        pc = pc[range_crop(pc)]
        n_budget = self.cfg.data.num_points
        if pc.shape[0] > n_budget:
            cache = os.path.join(d, f"{idx}_fpscache_{n_budget}.npy")
            sel = None
            if os.path.exists(cache):
                cached = np.load(cache)
                if cached[0] == pc.shape[0]:
                    sel = cached[1:]
            if sel is None:
                sel = np.asarray(self._fps(pc[:, :3], n_budget), np.int64)
                try:
                    np.save(cache, np.concatenate([[pc.shape[0]], sel]))
                except OSError:
                    pass
            pc = pc[sel]
        n = pc.shape[0]
        points = np.zeros((n_budget, 3), np.float32)
        points[:n] = pc[:n, :3]
        pmask = np.zeros(n_budget, bool)
        pmask[:n] = True

        if augment and self.cfg.data.augment:
            # after the cached crop + FPS, whose picks do not depend on
            # the pose, so the cache holds for every draw
            pts_aug, centers, headings, sizes = augment_scene(
                rng, points[:n], centers, headings, sizes,
                **resolve_aug(self.cfg.data, "kitti"))
            points[:n] = pts_aug[:, :3]

        votes = np.zeros((n_budget, 3), np.float32)
        vmask = np.zeros(n_budget, bool)
        if len(centers):
            boxes8 = np.concatenate(
                [centers, sizes, headings[:, None],
                 classes[:, None].astype(np.float32)], axis=1)
            votes[:n], vmask[:n] = host.vote_targets(points[:n], boxes8)
        V = max(1, self.cfg.data.vote_candidates)
        max_boxes = self.cfg.data.max_boxes
        if self.cfg.data.compact_votes:
            # int8 owners (the votes aim at the centers, so recovery is
            # exact); the step's decode rebuilds the [N,V,3] targets
            owner = recover_owner(points, votes, vmask, centers)
            vote_fields = {"vote_owner": compact_owner(owner, max_boxes)}
        else:
            if V > 1:
                # outdoor boxes never overlap, so every candidate slot
                # copies the single owner's offset
                votes = np.repeat(votes[:, None, :], V, axis=1)
            vote_fields = {"vote_targets": votes, "vote_mask": vmask}
        c, bm = pad_boxes(centers, max_boxes)
        s, _ = pad_boxes(sizes, max_boxes)
        h, _ = pad_boxes(headings, max_boxes)
        k, _ = pad_boxes(classes, max_boxes)
        # 3DSSD takes each point's intensity (and any further columns) as
        # its point features
        extra = {}
        if self.cfg.model.name == "ssd3d":
            F = self.cfg.model.ssd3d_point_features
            feats = np.zeros((n_budget, F), np.float32)
            feats[:n] = pc[:n, 3:3 + F]
            extra["point_features"] = feats
        return {
            "points": points,
            "point_mask": pmask,
            **extra,
            **vote_fields,
            "gt_centers": c,
            "gt_sizes": s,
            "gt_headings": h,
            "gt_classes": k,
            "gt_mask": bm,
        }

    def _batch(self, items, rng, batch_size, augment):
        picks = rng.choice(len(items), batch_size,
                           replace=len(items) < batch_size)
        out = [self._load_scene(*items[p], rng, augment) for p in picks]
        return {k: np.stack([it[k] for it in out]) for k in out[0]}

    def train_batch(self, rng, batch_size):
        return self._batch(self.train_items, rng, batch_size, augment=True)

    def val_batches(self, rng, batch_size):
        items = self.val_items or self.train_items
        yield from iter_val_batches(
            items, lambda it: self._load_scene(*it, rng, False), batch_size)
