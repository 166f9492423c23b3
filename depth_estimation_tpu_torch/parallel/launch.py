"""Start the ranks of a world (the port's stand-in for JAX's virtual devices).

The JAX package tests its sharded programs on one process with
``--xla_force_host_platform_device_count``. PyTorch runs one process a rank,
so ``spawn`` starts them:

* ``device="cpu"``: ``world_size`` processes (``torch.multiprocessing.spawn``)
  join a gloo group through a ``FileStore`` in a temporary directory (a file,
  not a TCP port, so that worlds started side by side cannot collide). Each
  rank runs with one intra-op thread.
* ``device="cuda"``: the caller is one rank of an NCCL world, started by
  ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) or initialized by the caller. ``spawn`` selects the rank's
  card, joins the world (initializing it from the environment if the caller
  has not) and runs ``fn`` in this process.

``fn(rank, *args)`` must be importable by name (a module-level function): the
CPU ranks import the module that defines it, so keep it in a module that
imports no JAX. Every rank's return value comes back, in rank order, to every
caller.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Any, Callable, List

import torch
import torch.distributed as dist

from depth_estimation_tpu_torch.device import resolve_device

TIMEOUT = datetime.timedelta(seconds=300)


def _cpu_rank(rank: int, fn: Callable, world_size: int, root: str, args: tuple) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "store"), world_size)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world_size, timeout=TIMEOUT)
    try:
        torch.save(fn(rank, *args), os.path.join(root, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, device="cuda", *args) -> List[Any]:
    """Run ``fn(rank, *args)`` on every rank of a world of ``world_size``;
    return the ranks' results in rank order."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        with tempfile.TemporaryDirectory(prefix="depth_tpu_torch_world_") as root:
            torch.multiprocessing.spawn(_cpu_rank, args=(fn, world_size, root, args), nprocs=world_size,
                                        join=True)
            # the files were written by this program's own ranks
            return [torch.load(os.path.join(root, f"result_{r}.pt"), weights_only=False)
                    for r in range(world_size)]
    if dev.type != "cuda":
        raise ValueError(f"spawn runs ranks on 'cpu' or 'cuda', not {dev}")
    started = not dist.is_initialized()
    if started:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl", timeout=TIMEOUT)
    else:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    try:
        if dist.get_backend() != "nccl":
            raise RuntimeError(f"the CUDA world runs over NCCL, not {dist.get_backend()}")
        if dist.get_world_size() != world_size:
            raise ValueError(f"asked for {world_size} ranks, the world has {dist.get_world_size()}")
        results: List[Any] = [None] * world_size
        dist.all_gather_object(results, fn(dist.get_rank(), *args))
        return results
    finally:
        if started:
            dist.destroy_process_group()
