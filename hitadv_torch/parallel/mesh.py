"""Process groups and batch sharding (port of `hitadv_tpu/parallel/mesh.py`).

Every attack is a function of ``(points [B, ...], labels [B],
generator)`` whose state is per example, so splitting the batch over the
ranks of a `torch.distributed` group runs it data-parallel. The JAX
package shards the batch over a device mesh and lets XLA partition the
program; here each rank runs the attack on its rows, inside
`parallel.shard.sharded`, so that the few batch-global terms (the loss
means, HiT-ADV's whole-tensor min and max, the random draws, the Add
attacks' host seeding) take the whole batch, and the results are
gathered. One process per device: NCCL between CUDA devices, gloo on the
CPU (or where ranks share a card).

The JAX package's multi-host launch (`put_batch`, each host feeding its
own shard of the batch) is not ported: `spawn` starts the ranks of one
host.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from hitadv_torch.parallel import comm
from hitadv_torch.parallel.shard import sharded


def backend_for(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_devices(n: int, device) -> None:
    """Raise when ``n`` ranks would need more CUDA devices than the
    machine has (one rank a device; the JAX package's `make_mesh` takes
    the devices it finds instead)."""
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(f"{n} ranks need {n} CUDA devices, one each; "
                             f"this machine has {have}")


def make_mesh(n_devices: Optional[int] = None):
    """The process group of the first ``n_devices`` ranks (default: all)
    of the initialised default group."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; start the ranks with "
            "parallel.spawn (python -m hitadv_torch.eval does) or "
            "torch.distributed.init_process_group")
    have = dist.get_world_size()
    if n_devices is None or n_devices == have:
        return dist.group.WORLD
    if not 1 <= n_devices <= have:
        raise ValueError(f"make_mesh: {n_devices} ranks of {have}")
    return dist.new_group(list(range(n_devices)))


def _rank_main(rank: int, fn: Callable, world: int, init_method: str,
               backend: str, out_path: str, args: Sequence) -> None:
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    try:
        result = fn(rank, *args)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (),
          backend: str = "gloo"):
    """Run ``fn(rank, *args)`` in ``world`` new processes joined in one
    process group of ``backend`` (rendezvous through a file in a
    temporary directory, so no port is taken), wait for all of them, and
    return rank 0's result. A rank's error ends the others and is raised
    here."""
    tmp = tempfile.mkdtemp(prefix="hitadv_mesh_")
    out_path = os.path.join(tmp, "rank0.pkl")
    try:
        torch.multiprocessing.spawn(
            _rank_main, nprocs=world, join=True,
            args=(fn, world, f"file://{tmp}/rendezvous", backend, out_path,
                  tuple(args)))
        with open(out_path, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def shard_attack(attack_fn: Callable, group) -> Callable:
    """Wrap an attack so that each rank of ``group`` attacks its rows of
    the batch (the ranks hold the same whole batch and the same
    generator) and every rank gets the whole batch's `AttackResult`, as
    one process running ``attack_fn`` on it would (within the rounding of
    the sums that the ranks split). The batch size must be divisible by
    the group's size."""

    def wrapped(points, labels, generator=None):
        D, r = comm.world(group), comm.rank(group)
        B = len(points)
        if B % D:
            raise ValueError(
                f"shard_attack: global batch {B} is not divisible"
                f" by the {D}-device mesh — pad the batch or shrink"
                " the mesh (parallel.make_mesh(n_devices=...))")
        rows = slice(r * (B // D), (r + 1) * (B // D))
        with sharded(group):
            res = attack_fn(points[rows], labels[rows], generator)
        return res._make(comm.all_gather(t, group) for t in res)

    return wrapped
