"""The batch sharding an attack runs under, and the batch-global terms.

`mesh.shard_attack` runs an attack on each rank's rows of one global
batch, inside `sharded`. The few terms that couple a batch's examples go
through the helpers below, so that each rank's rows come out as they
would in one process holding the whole batch: the batch means and sums
of the losses (`batch_mean`, `batch_sum`), HiT-ADV's whole-tensor min
and max (`batch_amin`, `batch_amax`), the random draws (`batch_draw`:
the whole batch's shape from the generator every rank holds, then this
rank's rows) and the host seeding of the Add attacks and the defenses
(`gather_batch`, `own_rows`, `whole_batch`). Outside `sharded` each is
the plain single-process operation.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import torch

from hitadv_torch.parallel import comm


class Shard(NamedTuple):
    """This rank's place in the process group the batch is split over."""
    group: object
    rank: int
    world: int


_SHARD: Optional[Shard] = None


@contextlib.contextmanager
def sharded(group):
    """Run the attacks in the block on this rank's rows of a batch split
    over ``group``'s ranks in rank order."""
    global _SHARD
    prev = _SHARD
    _SHARD = Shard(group, comm.rank(group), comm.world(group))
    try:
        yield
    finally:
        _SHARD = prev


def own_rows(x):
    """This rank's rows of a whole batch's ``x`` (all of it outside
    `sharded`)."""
    if _SHARD is None:
        return x
    n = x.shape[0] // _SHARD.world
    return x[_SHARD.rank * n:(_SHARD.rank + 1) * n]


def whole_batch(rows: int) -> int:
    """The size of the whole batch of which this rank holds ``rows``."""
    return rows if _SHARD is None else rows * _SHARD.world


def batch_draw(draw: Callable, shape) -> torch.Tensor:
    """``draw(shape)`` for this rank's rows: under `sharded`, the draw of
    the whole batch's shape (``shape[0]`` times the ranks), of which this
    rank keeps its rows, so that every example draws what it draws in one
    process."""
    return own_rows(draw((whole_batch(shape[0]),) + tuple(shape[1:])))


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``torch.sum(x)`` over the whole batch (differentiable)."""
    if _SHARD is None:
        return torch.sum(x)
    return comm.AllReduceSum.apply(torch.sum(x), _SHARD.group)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``torch.mean(x)`` over the whole batch (differentiable)."""
    if _SHARD is None:
        return torch.mean(x)
    return batch_sum(x) / (x.numel() * _SHARD.world)


def batch_amin(x: torch.Tensor) -> torch.Tensor:
    """``torch.amin(x)`` over the whole batch (no gradient)."""
    if _SHARD is None:
        return torch.amin(x)
    return comm.all_reduce(torch.amin(x), _SHARD.group,
                           comm.dist.ReduceOp.MIN)


def batch_amax(x: torch.Tensor) -> torch.Tensor:
    """``torch.amax(x)`` over the whole batch (no gradient)."""
    if _SHARD is None:
        return torch.amax(x)
    return comm.all_reduce(torch.amax(x), _SHARD.group,
                           comm.dist.ReduceOp.MAX)


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The whole batch's ``x``, this rank's rows among the others' (no
    gradient)."""
    if _SHARD is None:
        return x
    return comm.all_gather(x, _SHARD.group)
