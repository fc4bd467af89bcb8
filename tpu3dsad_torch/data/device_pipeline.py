"""Input pipeline on the card (tpu3dsad/data/device_pipeline.py):
augmentation, vote targets and synthetic scenes, as tensor programs.

* `augment_batch` flips, rotates and scales a padded detection batch per
  scene, by the recipe of augment.resolve_aug. Vote targets and GT boxes are offsets and poses that transform
  linearly, so transforming them directly equals recomputing the votes
  after augmenting (ownership is invariant under a rigid transform and a
  uniform scale).
* `expand_votes` builds the vote targets from per-point owners.
* `synthetic_detection_batch` generates a whole batch of procedural
  indoor scenes (floor + box-surface furniture + analytic vote targets) on
  the generator's device.

Random numbers come from a torch.Generator, so the draws differ from the
reference's jax.random ones; the distributions and target conventions are
the same. Rotations are written elementwise, and expand_votes selects
centers by index, so every coordinate stays exact fp32 whatever matmul
precision a run sets.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3dsad_torch.config import class_mean_sizes
from tpu3dsad_torch.ops.boxes import mod
from tpu3dsad_torch.parallel.collectives import batch_rows
from tpu3dsad_torch.utils.constants import device_constant


def _uniform(generator, shape, lo, hi, device):
    return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo


def draw_augment(generator, batch_size: int, *, flip_x: bool = True,
                 flip_y: bool = True, rot_range: float = np.pi / 36,
                 scale_range=None, device=None) -> dict:
    """Per-scene draws of one augment_batch call: flip_x / flip_y [B] bool
    (or None when off), angle [B], scale [B] (or None)."""
    B = batch_size

    def coin():
        return torch.rand(B, generator=generator, device=device) < 0.5

    return {
        "flip_x": coin() if flip_x else None,
        "flip_y": coin() if flip_y else None,
        "angle": _uniform(generator, B, -rot_range, rot_range, device),
        "scale": (None if scale_range is None else
                  _uniform(generator, B, scale_range[0], scale_range[1],
                           device)),
    }


def _rotate_xy(v, c, s):
    """Rotate the xy of v [B, ..., 3] by per-scene cos/sin c, s [B]."""
    shape = (-1,) + (1,) * (v.dim() - 2)
    c, s = c.reshape(shape), s.reshape(shape)
    x, y = v[..., 0], v[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y, v[..., 2]], -1)


def apply_augment(batch: dict, draws: dict) -> dict:
    """Flip, rotate and scale points, vote_targets ([B,N,3] or [B,N,V,3]),
    gt_centers, gt_headings and gt_sizes of a batch by `draws`
    (draw_augment's dict); other keys pass through."""
    points, votes = batch["points"], batch["vote_targets"]
    centers, headings = batch["gt_centers"], batch["gt_headings"]
    sizes = batch["gt_sizes"]

    def flip(v, ax, do):
        sign = device_constant(np.where(np.arange(3) == ax, -1.0, 1.0),
                               v.device)
        shape = (-1,) + (1,) * (v.dim() - 1)
        return torch.where(do.reshape(shape), v * sign, v)

    for ax, key in ((0, "flip_x"), (1, "flip_y")):
        do = draws[key]
        if do is None:
            continue
        points, votes, centers = (flip(v, ax, do)
                                  for v in (points, votes, centers))
        # x-flip: h -> pi - h; y-flip: h -> -h
        headings = torch.where(do[:, None],
                               (np.pi - headings) if ax == 0 else -headings,
                               headings)

    angle = draws["angle"]
    c, s = torch.cos(angle), torch.sin(angle)
    points, votes, centers = (_rotate_xy(v, c, s)
                              for v in (points, votes, centers))
    headings = headings + angle[:, None]

    if draws["scale"] is not None:
        def scaled(v):
            return v * draws["scale"].reshape((-1,) + (1,) * (v.dim() - 1))
        points, votes, centers, sizes = map(scaled,
                                            (points, votes, centers, sizes))

    out = dict(batch)
    out["points"] = points
    out["vote_targets"] = votes
    out["gt_centers"] = centers
    out["gt_headings"] = mod(headings + np.pi, 2 * np.pi) - np.pi
    out["gt_sizes"] = sizes
    return out


def augment_batch(batch: dict, generator, flip_x: bool = True,
                  flip_y: bool = True, rot_range: float = np.pi / 36,
                  scale_range=None) -> dict:
    """Per-scene flip/rot/scale of a padded detection batch. Under data
    parallelism the draws are made for the global batch and cut to this
    rank's rows (collectives.batch_rows)."""
    rows, mine = batch_rows(batch["points"].shape[0])
    draws = draw_augment(generator, rows, flip_x=flip_x, flip_y=flip_y,
                         rot_range=rot_range, scale_range=scale_range,
                         device=batch["points"].device)
    return apply_augment(batch, {k: None if v is None else v[mine]
                                 for k, v in draws.items()})


def expand_votes(points, owner, gt_centers, gt_sizes, gt_headings,
                 gt_valid, vote_candidates: int):
    """Vote targets from per-point primary owners.

    points [B,N,3]; owner [B,N] int (index into the padded GT arrays, < 0
    for points that do not vote); gt_* [B,G,...]; gt_valid [B,G] bool.
    Returns (vote_targets [B,N,3], or [B,N,V,3] when vote_candidates > 1,
    vote_mask [B,N]). Slot 0 is the offset to the primary owner's center;
    slots 1..V-1 take the OTHER valid boxes containing the point (oriented
    containment, box-index order); unused slots copy the primary."""
    owner = owner.long()
    centers = gt_centers
    G = centers.shape[1]
    vote_mask = owner >= 0
    own = owner.clamp_min(0)
    own_center = torch.gather(centers, 1, own[..., None].expand(-1, -1, 3))
    votes = torch.where(vote_mask[..., None], own_center - points, 0.0)
    if vote_candidates > 1:
        ch = torch.cos(gt_headings)[:, None, :]  # [B,1,G]
        sh = torch.sin(gt_headings)[:, None, :]
        rx = points[..., 0:1] - centers[..., 0][:, None, :]  # [B,N,G]
        ry = points[..., 1:2] - centers[..., 1][:, None, :]
        lz = points[..., 2:3] - centers[..., 2][:, None, :]
        lx = ch * rx + sh * ry
        ly = -sh * rx + ch * ry
        half = gt_sizes[:, None, :, :] / 2 + 1e-6  # [B,1,G,3]
        inside = ((lx.abs() <= half[..., 0]) & (ly.abs() <= half[..., 1])
                  & (lz.abs() <= half[..., 2]))
        inside = inside & gt_valid[:, None, :] & vote_mask[:, :, None]
        box = torch.arange(G, device=points.device)
        inside = inside & (box[None, None, :] != own[:, :, None])
        # rank of each containing box among the point's OTHER containing
        # boxes, in box-index order
        ins = inside.int()
        rank = ins.cumsum(-1) - ins
        slots = [votes]
        for v in range(vote_candidates - 1):
            match = inside & (rank == v)  # at most one box per point
            j = match.int().argmax(-1)
            cand = torch.gather(centers, 1, j[..., None].expand(-1, -1, 3))
            slots.append(torch.where(match.any(-1)[..., None],
                                     cand - points, votes))
        votes = torch.stack(slots, 2)
    return votes.float(), vote_mask


def decode_compact_votes(batch: dict, vote_candidates: int) -> dict:
    """Replace a batch's `vote_owner` (the compact-votes format) with
    `vote_targets`/`vote_mask`; a no-op for batches that carry targets."""
    if "vote_owner" not in batch:
        return batch
    out = dict(batch)
    owner = out.pop("vote_owner")
    out["vote_targets"], out["vote_mask"] = expand_votes(
        out["points"], owner, out["gt_centers"], out["gt_sizes"],
        out["gt_headings"], out["gt_mask"], vote_candidates)
    return out


def _rot_z(local, heading):
    """Rotate local [B,G,P,3] about z by heading [B,G]."""
    c = torch.cos(heading)[:, :, None]
    s = torch.sin(heading)[:, :, None]
    x, y = local[..., 0], local[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y, local[..., 2]], -1)


def synthetic_detection_batch(generator: torch.Generator, batch_size: int,
                              num_points: int, num_classes: int = 4,
                              max_boxes: int = 64, max_objects: int = 8,
                              min_objects: int = 3, room: float = 4.0,
                              vote_candidates: int = 1) -> dict:
    """A padded detection batch of procedural scenes, made on the
    generator's device (data/synthetic.py semantics).

    Every scene has g in [min_objects, max_objects] boxes on the floor of a
    room x room square; the point slots of disabled object slots become
    extra floor points."""
    dev = generator.device
    B, N = batch_size, num_points
    G = min(max_objects, max_boxes)
    min_objects = min(min_objects, G)
    mean_sizes = device_constant(class_mean_sizes(num_classes), dev)

    def uniform(shape, lo, hi):
        return _uniform(generator, shape, lo, hi, dev)

    g = torch.randint(min_objects, max_objects + 1, (B,),
                      generator=generator, device=dev)
    obj_valid = torch.arange(G, device=dev)[None, :] < g[:, None]  # [B,G]
    classes = torch.randint(0, num_classes, (B, G), generator=generator,
                            device=dev)
    sizes = mean_sizes[classes] * uniform((B, G, 3), 0.8, 1.25)
    headings = uniform((B, G), -np.pi, np.pi)
    cxy = uniform((B, G, 2), -room / 2 + 1, room / 2 - 1)
    centers = torch.cat([cxy, sizes[..., 2:] / 2], -1)  # on the floor

    # point budget: a floor block + equal per-slot object blocks
    per = (N - N // 4) // G
    n_obj = per * G
    n_floor = N - n_obj

    def floor_points(*shape):
        xy = uniform((*shape, 2), -room / 2, room / 2)
        z = 0.01 * torch.randn((*shape, 1), generator=generator, device=dev)
        return torch.cat([xy, z], -1)

    floor = floor_points(B, n_floor)
    # box-surface samples: uniform in the cube, one axis snapped to +-1
    cube = uniform((B, G, per, 3), -1.0, 1.0)
    ax = torch.randint(0, 3, (B, G, per), generator=generator, device=dev)
    sign = torch.where(
        torch.rand((B, G, per), generator=generator, device=dev) < 0.5,
        1.0, -1.0)
    snap = torch.nn.functional.one_hot(ax, 3).float()
    cube = cube * (1 - snap) + sign[..., None] * snap
    local = cube * 0.5 * sizes[:, :, None, :]
    obj_pts = _rot_z(local, headings) + centers[:, :, None, :]
    extra = floor_points(B, G, per)
    obj_pts = torch.where(obj_valid[:, :, None, None], obj_pts, extra)

    points = torch.cat([floor, obj_pts.reshape(B, n_obj, 3)], 1)
    slot = torch.where(obj_valid, torch.arange(G, device=dev)[None, :], -1)
    owner = torch.cat([torch.full((B, n_floor), -1, device=dev),
                       slot.repeat_interleave(per, 1)], 1)

    votes, vote_mask = expand_votes(points, owner, centers, sizes, headings,
                                    obj_valid, vote_candidates)
    pad = max_boxes - G

    def padded(x):
        return torch.cat([x, x.new_zeros((B, pad) + x.shape[2:])], 1)

    return {
        "points": points.float(),
        "point_mask": torch.ones((B, N), dtype=torch.bool, device=dev),
        "vote_targets": votes,
        "vote_mask": vote_mask,
        "gt_centers": padded(centers).float(),
        "gt_sizes": padded(sizes).float(),
        "gt_headings": padded(headings).float(),
        "gt_classes": padded(classes).int(),
        "gt_mask": padded(obj_valid),
    }
