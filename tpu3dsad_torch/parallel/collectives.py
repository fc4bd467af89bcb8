"""Collectives over torch.distributed process groups, and the data-parallel
group a train step runs under.

This is the one module of the port that calls torch.distributed, and it
calls only `all_reduce` and `broadcast`: the two collectives gloo runs on
CUDA tensors, which is what puts two ranks on one card. Everything else is
built from them:

  * `all_reduce_sum(x, group)`: the sum over the group, differentiable;
    its backward all-reduces the incoming gradient. That is the rule for a
    sum whose ranks go on to compute different losses (the data axis:
    rank r's loss is its own part of the global one, so x_r's gradient is
    the sum of every rank's);
  * `replicated_sum(x, group)`: the same sum where every rank of the group
    goes on to compute the same (replicated) loss, as the points axis does
    in context parallelism; its backward passes the gradient through;
  * `all_gather(x, group)`: [p, ...], slot i from the group's i-th rank,
    as an all_reduce of a zero-filled buffer in which each rank fills only
    its own slot. x + 0 = x for every finite value, +-inf and NaN, so the
    gather is exact (a -0.0 comes back as +0.0, equal in value); integer
    tensors gather exactly too; bool tensors go as uint8;
  * `broadcast(x, group, src)`: the value of the group's rank `src`.

A group here is an `AxisGroup` (parallel/mesh.py): a process group, this
rank's index in it and its size. None, or a group of size 1, is no group:
every function returns its input and nothing is communicated. `calls`
counts the collectives launched (the one-collective-a-pick check of
sharded_fps reads it).

`data_parallel(group)` sets the group of the data axis for the block it
runs: masked BatchNorm reduces its statistics over it (nn/norm.py), the
losses take their denominators over it (losses.py), and draws made for the
global batch keep this rank's rows of it (`batch_rows`). Outside it, or
with None, the step is a one-device step.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

calls = 0  # collectives launched in this process

_data_group = None  # AxisGroup of the data axis, or None


def active(group) -> bool:
    """Whether `group` (an AxisGroup or None) takes part in a step: a
    group of more than one rank."""
    return group is not None and group.size > 1


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum t in place over `group` (an AxisGroup of size > 1)."""
    global calls
    calls += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _ReplicatedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`; its backward all-reduces the gradient
    (module docstring)."""
    if not active(group):
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(x, group)
    return _all_reduce(x.clone(memory_format=torch.contiguous_format), group)


def replicated_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`, whose ranks all compute the same loss
    from it; its backward passes the gradient through."""
    if not active(group):
        return x
    if x.requires_grad:
        return _ReplicatedSum.apply(x, group)
    return _all_reduce(x.clone(memory_format=torch.contiguous_format), group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[p, *x.shape]: slot i holds the x of the group's i-th rank; [1, ...]
    without a group. No gradient."""
    if not active(group):
        return x.detach()[None]
    wire = x.detach().to(torch.uint8) if x.dtype == torch.bool else x.detach()
    buf = wire.new_zeros((group.size, *x.shape))
    buf[group.rank] = wire
    _all_reduce(buf, group)
    return buf.bool() if x.dtype == torch.bool else buf


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """x of the group's rank `src` (an index into the group), in place."""
    global calls
    if not active(group):
        return x
    calls += 1
    dist.broadcast(x, src=group.ranks[src], group=group.group)
    return x


def all_reduce_coalesced(tensors: list[torch.Tensor], group) -> None:
    """Sum each tensor over `group`, in place, through one flat buffer
    (one collective)."""
    if not active(group) or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce(flat, group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


@contextlib.contextmanager
def data_parallel(group):
    """Run a block with `group` (an AxisGroup or None) as the data axis; a
    group of one rank is no group."""
    global _data_group
    old, _data_group = _data_group, group if active(group) else None
    try:
        yield
    finally:
        _data_group = old


def data_group():
    """The AxisGroup of the data axis set by data_parallel (of more than
    one rank), or None."""
    return _data_group


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """all_reduce_sum over the data axis (x itself outside data_parallel)."""
    return all_reduce_sum(x, _data_group)


def batch_rows(local_rows: int) -> tuple[int, slice]:
    """(rows of the global batch, the slice of them this rank holds) for a
    rank that holds `local_rows`: the global batch is local_rows x the data
    axis' size, split in contiguous rows by rank, as shard_batch lays a
    batch out. A draw made for the global batch from the same generator on
    every rank and cut by the slice gives each rank what a world-1 step of
    the global batch gives those rows."""
    g = _data_group
    if not active(g):
        return local_rows, slice(0, local_rows)
    return (local_rows * g.size,
            slice(g.rank * local_rows, (g.rank + 1) * local_rows))
