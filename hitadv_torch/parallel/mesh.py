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

Across hosts (the JAX package's multi-host launch, :31-89), `spawn` on
each host joins that host's ranks to one group through a rendezvous the
user names, and records the host count and this host's index (`hosts`,
the counterpart of ``jax.process_count()`` / ``jax.process_index()``).
Each host then passes only its own shard of the global batch: `put_batch`
gives the host's ranks its first rank's shard (the JAX package's one
process a host), and `shard_attack` gives each of them its rows of it.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from hitadv_torch.parallel import comm
from hitadv_torch.parallel.shard import sharded


class Hosts(NamedTuple):
    """The number of hosts the ranks were started on and this process's
    host among them."""
    count: int
    index: int


_HOSTS = Hosts(1, 0)
# across hosts, the group of this host's ranks (`spawn`)
_HOST_GROUP = None


def hosts() -> Hosts:
    """This rank's `Hosts`: as `spawn` started it, else one host."""
    return _HOSTS


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


def _rank_main(local: int, fn: Callable, world: int, n_hosts: int,
               host: int, init_method: str, backend: str, out_path: str,
               args: Sequence) -> None:
    global _HOSTS, _HOST_GROUP
    rank = host * world + local
    dist.init_process_group(backend, init_method=init_method,
                            world_size=n_hosts * world, rank=rank)
    _HOSTS = Hosts(n_hosts, host)
    if n_hosts > 1:
        # every rank makes every host's group, in host order
        _HOST_GROUP = [dist.new_group(list(range(h * world, (h + 1) * world)))
                       for h in range(n_hosts)][host]
    try:
        result = fn(rank, *args)
        if local == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (),
          backend: str = "gloo", *, init_method: Optional[str] = None,
          n_hosts: int = 1, host: int = 0):
    """Run ``fn(rank, *args)`` in ``world`` new processes joined in one
    process group of ``backend``, wait for all of them, and return the
    result of this host's first rank. A rank's error ends the others and
    is raised here.

    Without ``init_method`` the group is this host's ``world`` ranks,
    joined through a file in a temporary directory (no port is taken).
    Across hosts, every host makes this call with the same rendezvous
    ``init_method`` (a ``file://`` path that every host reaches, or
    ``tcp://<first host>:<port>``), the same ``world`` (its ranks) and
    ``n_hosts``, and its own index ``host``: its ranks join the group of
    ``n_hosts * world`` as the global ranks ``host * world + local``, and
    `hosts` reads ``(n_hosts, host)`` in them."""
    if not 0 <= host < n_hosts:
        raise ValueError(f"spawn: host {host} outside [0, {n_hosts})")
    if n_hosts > 1 and init_method is None:
        raise ValueError("spawn: ranks on several hosts need a rendezvous "
                         "that every host reaches (init_method)")
    tmp = tempfile.mkdtemp(prefix="hitadv_mesh_")
    out_path = os.path.join(tmp, "rank0.pkl")
    try:
        torch.multiprocessing.spawn(
            _rank_main, nprocs=world, join=True,
            args=(fn, world, n_hosts, host,
                  init_method or f"file://{tmp}/rendezvous", backend,
                  out_path, tuple(args)))
        with open(out_path, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def put_batch(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's ``x`` as `shard_attack` takes it: one value for all the
    ranks of a host, whatever their loaders drew (a threaded loader's
    draws depend on thread timing, `ROADMAP.md` §3).

    On one host every rank of ``group`` takes rank 0's ``x`` (a
    broadcast). Across hosts ``x`` is this host's shard of the global
    batch: every rank of the host takes its first rank's, and no data
    crosses hosts, as ``make_array_from_process_local_data`` places a
    host's shard on that host's devices."""
    if hosts().count > 1:
        return comm.broadcast(x, _HOST_GROUP)
    return comm.broadcast(x, group)


def _local_rows(n: int, group) -> slice:
    """This rank's rows of the ``n`` its host holds (all the batch on one
    host): the group's ranks split the global batch in rank order, each
    host's ranks its shard."""
    D, r = comm.world(group), comm.rank(group)
    H, h = hosts()
    L = D // H
    if D % H or r // L != h:
        raise ValueError(
            f"shard_attack: rank {r} of {D} is not one of host {h}'s "
            f"{L} ranks; the group must hold every host's ranks, in host "
            "order")
    per = n // L
    return slice((r % L) * per, (r % L + 1) * per)


def shard_attack(attack_fn: Callable, group) -> Callable:
    """Wrap an attack so that each rank of ``group`` attacks its rows of
    the global batch and every rank gets the whole global batch's
    `AttackResult`, as one process running ``attack_fn`` on it would
    (within the rounding of the sums that the ranks split). On one host
    the ranks pass the same whole batch; across hosts (`spawn` with
    ``n_hosts``) each host's ranks pass that host's shard, and the global
    batch is that times the hosts. Every rank passes the same generator.
    The global batch must be divisible by the group's size."""

    def wrapped(points, labels, generator=None):
        D = comm.world(group)
        B = len(points) * hosts().count
        if B % D:
            raise ValueError(
                f"shard_attack: global batch {B} is not divisible"
                f" by the {D}-device mesh — pad the batch or shrink"
                " the mesh (parallel.make_mesh(n_devices=...))")
        rows = _local_rows(len(points), group)
        with sharded(group):
            res = attack_fn(points[rows], labels[rows], generator)
        return res._make(comm.all_gather(t, group) for t in res)

    return wrapped
