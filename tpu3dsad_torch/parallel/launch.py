"""Starting the ranks of a data- or context-parallel run.

  * `init_from_env(device)`: for a process started by torchrun
    (`python -m torch.distributed.run`), which sets RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR and MASTER_PORT. On the card each rank takes
    cuda:LOCAL_RANK and NCCL; on the CPU, gloo. `ranks_from_env` wraps it
    around a block and leaves the group at its end.
  * `spawn(fn, world, backend=, device=, init_file=)`: starts `world`
    processes here and returns what fn returned on each rank, in rank
    order. The ranks meet through the file `init_file` (file://), so runs
    side by side never share a port. This is how the CPU tests run gloo
    ranks, and how one card holds two ranks: gloo on CUDA tensors, asked
    for by name (NCCL puts one rank on a card).

No backend is ever chosen in place of the one asked for: NCCL asked for
where it is missing raises.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _check_backend(backend: str) -> None:
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("the NCCL backend was asked for and this torch "
                           "has none; ask for gloo by name to use it")
    if backend == "gloo" and not dist.is_gloo_available():
        raise RuntimeError("the gloo backend was asked for and this torch "
                           "has none")


def init_from_env(device="cuda", backend: str | None = None):
    """Join the process group torchrun describes in the environment, and
    return this rank's device: cuda:LOCAL_RANK (made current) for a CUDA
    `device`, with NCCL unless `backend` names another, else the CPU with
    gloo. Returns None, and joins nothing, outside torchrun (no RANK in
    the environment) or where the group is already made."""
    if "RANK" not in os.environ or dist.is_initialized():
        return None
    rank = int(os.environ["RANK"])
    world_size = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", 0))
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_from_env(device='cuda'): no CUDA device "
                               "is available; pass device='cpu'")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = backend or "nccl"
    else:
        device = torch.device("cpu")
        backend = backend or "gloo"
    _check_backend(backend)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world_size)
    print(f"rank {rank} of {world_size}: backend {backend}, device {device}",
          file=sys.stderr, flush=True)
    return device


@contextlib.contextmanager
def ranks_from_env(device="cuda", backend: str | None = None):
    """Run a block in the process group torchrun describes, where there is
    one: yields init_from_env's device (None outside torchrun), and leaves
    the group it joined when the block ends."""
    joined = init_from_env(device, backend)
    try:
        yield joined
    finally:
        if joined is not None:
            dist.destroy_process_group()


def _run_rank(rank, fn, world, backend, device, init_file, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(fn, world: int, *, backend: str, device="cpu", init_file=None,
          args=()) -> list:
    """Run fn(rank, world, *args) in `world` new processes joined in one
    process group of `backend`, and return the results in rank order
    (saved with torch.save and loaded here on the CPU). `device` is
    checked, not used: fn places its own tensors. fn must be importable
    by name (a module-level function), and import neither JAX nor
    anything that does. A rank that raises makes spawn raise."""
    _check_backend(backend)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"spawn(device={device!r}): no CUDA device")
    with tempfile.TemporaryDirectory(prefix="tpu3dsad_spawn_") as out_dir:
        init_file = init_file or os.path.join(out_dir, "rendezvous")
        if Path(init_file).exists():
            raise ValueError(f"init_file {init_file} exists: the rendezvous "
                             "needs a fresh file")
        mp.start_processes(
            _run_rank, args=(fn, world, backend, device, str(init_file),
                             out_dir, tuple(args)),
            nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
