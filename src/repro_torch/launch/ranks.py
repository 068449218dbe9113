"""Run a function on ``world`` ranks of one host: one spawned process each,
joined by a ``torch.distributed`` process group.

    results = spawn_ranks(fn, 4, (arg,), workdir=tmp)

``fn(rank, world, *args)`` runs in every rank after a gloo process group
is up (gloo, as NCCL refuses two ranks on one card; rendezvous through a
file under ``workdir``, so that concurrent runs never race for a port),
and each rank's return value comes back to the caller in rank order,
through ``torch.save`` files under ``workdir``. ``fn`` must be importable by name
(a module-level function), as spawn requires. Each rank caps torch's CPU
threads at ``threads``: the ranks share the host's cores.
"""

from __future__ import annotations

import itertools
import os
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_runs = itertools.count()


def _child(rank: int, fn, world: int, args: tuple, rendezvous: str,
           out: str, threads: int) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args: tuple = (), *, workdir,
                threads: int = 1) -> list:
    """Each rank's ``fn(rank, world, *args)``, in rank order (module
    docstring)."""
    run = Path(workdir) / f"ranks_{os.getpid()}_{next(_runs)}"
    run.mkdir(parents=True)
    rendezvous = run / "rendezvous"
    mp.start_processes(
        _child, args=(fn, world, args, str(rendezvous), str(run), threads),
        nprocs=world, join=True, start_method="spawn",
    )
    return [torch.load(run / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
