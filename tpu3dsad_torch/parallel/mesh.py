"""A named mesh over the ranks of a torch.distributed process group
(tpu3dsad/parallel/mesh.py).

The reference lays its devices out in a grid with named axes and shards
arrays over them. Here every rank is one process: `make_mesh` lays the
ranks 0..world-1 out row-major in the grid, as the reference reshapes its
device list, and gives each axis a process group per slice (the ranks
that differ only in that axis' coordinate). `shard_batch` keeps this
rank's contiguous rows of a batch, as NamedSharding lays them out.

Without a process group, or with a world of 1, the mesh is trivial: every
axis has size 1, no group is made, and shard_batch returns the batch as
it is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch.distributed as dist


@dataclass(frozen=True)
class AxisGroup:
    """The slice of one mesh axis that holds this rank: the process group
    (None where the slice is this rank alone), this rank's index in it,
    its size and its global ranks in axis order."""

    group: object
    rank: int
    size: int
    ranks: tuple[int, ...]


class Mesh:
    """shape[axis] -> size; axis_index(axis) -> this rank's coordinate;
    group(axis) -> AxisGroup; rank: this process's global rank."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...],
                 rank: int, groups: dict):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.rank = rank
        self._coords = dict(zip(self.axis_names,
                                np.unravel_index(rank, shape)))
        self._groups = groups

    def axis_index(self, axis: str) -> int:
        return int(self._coords[self._check(axis)])

    def group(self, axis: str) -> AxisGroup:
        return self._groups[self._check(axis)]

    def _check(self, axis: str) -> str:
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}; its axes are "
                             f"{self.axis_names}")
        return axis

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def resolve_shape(mesh_shape, world_size: int) -> tuple[int, ...]:
    """mesh_shape with its -1 (at most one) absorbing the ranks the other
    sizes leave."""
    shape = [int(s) for s in mesh_shape]
    if shape.count(-1) > 1 or any(s == 0 or s < -1 for s in shape):
        raise ValueError(f"mesh_shape {tuple(mesh_shape)}: sizes must be "
                         "positive, with at most one -1")
    known = math.prod(s for s in shape if s != -1)
    if -1 in shape:
        shape[shape.index(-1)] = max(1, world_size // known)
    return tuple(shape)


def make_mesh(mesh_shape=(-1,), axis_names=("data",)) -> Mesh:
    """The mesh of the process group's ranks; -1 in mesh_shape absorbs all
    remaining ranks. Every rank must call it, with the same arguments and
    in the same order as its other new_group calls: the groups of every
    slice are made on every rank. The mesh must hold every rank."""
    axis_names = tuple(axis_names)
    if len(axis_names) != len(tuple(mesh_shape)):
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} and mesh_axes "
                         f"{axis_names} differ in length")
    if len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh_axes {axis_names} repeat a name")
    rank, world_size = world()
    shape = resolve_shape(mesh_shape, world_size)
    if math.prod(shape) != world_size:
        raise ValueError(
            f"mesh_shape {tuple(mesh_shape)} holds {math.prod(shape)} ranks "
            f"but the process group has {world_size}: launch one process "
            "a rank (torchrun --nproc-per-node=..., or parallel.spawn), "
            "and give the mesh every rank")
    grid = np.arange(world_size).reshape(shape)
    coords = np.unravel_index(rank, shape)
    groups = {}
    for a, name in enumerate(axis_names):
        # every slice along axis a, in one order on every rank
        lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        mine = tuple(int(r) for r in np.moveaxis(grid, a, -1)[
            tuple(c for i, c in enumerate(coords) if i != a)])
        group = None
        if shape[a] > 1:
            for line in lines:
                ranks = [int(r) for r in line]
                g = dist.new_group(ranks)
                if tuple(ranks) == mine:
                    group = g
        groups[name] = AxisGroup(group, int(coords[a]), shape[a], mine)
    return Mesh(shape, axis_names, rank, groups)


def take_rows(x, index: int, parts: int, axis: int = 0):
    """The index-th of `parts` contiguous, equal blocks of x along `axis`
    (a tensor or an array); x itself where parts is 1."""
    if parts == 1 or x is None:
        return x
    n = x.shape[axis]
    if n % parts:
        raise ValueError(f"a batch axis of {n} does not split into {parts} "
                         "equal parts")
    rows = n // parts
    return x[(slice(None),) * axis + (slice(index * rows,
                                            (index + 1) * rows),)]


@dataclass(frozen=True)
class BatchSharding:
    """A batch's layout over a mesh (the reference's NamedSharding of a
    batch): its dimension `batch_axis_index` split in contiguous rows over
    `axis`, or replicated where axis is None. Called on a tensor or an
    array, it returns this rank's part."""

    mesh: Mesh
    axis: str | None
    batch_axis_index: int = 0

    def __call__(self, x):
        if self.axis is None:
            return x
        return take_rows(x, self.mesh.axis_index(self.axis),
                         self.mesh.shape[self.axis], self.batch_axis_index)


def batch_sharding(mesh: Mesh, axis: str = "data",
                   batch_axis_index: int = 0) -> BatchSharding:
    """The batch dimension (at batch_axis_index; 1 serves the [k, B, ...]
    blocks of train.steps_per_call) split over `axis`."""
    mesh.axis_index(axis)  # raises for an axis the mesh lacks
    return BatchSharding(mesh, axis, batch_axis_index)


def replicated(mesh: Mesh) -> BatchSharding:
    return BatchSharding(mesh, None)


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data",
                batch_axis_index: int = 0) -> dict:
    """This rank's rows of every entry of `batch` (batch_sharding)."""
    sharding = batch_sharding(mesh, axis, batch_axis_index)
    return {k: sharding(v) for k, v in batch.items()}
