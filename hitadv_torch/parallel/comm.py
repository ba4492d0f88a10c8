"""Collectives over a `torch.distributed` process group, for the mesh
(`parallel.mesh`), the ring (`parallel.ring`) and the sharded attacks'
batch-global terms (`parallel.shard`).

Each takes the group explicitly. NCCL moves CUDA tensors; gloo moves CPU
tensors, and a CUDA tensor handed to a gloo group is staged through host
memory (copied out, exchanged, copied back), whatever the op: gloo's CUDA
support differs from op to op. A group whose ranks share one card (the
check of the mesh code on a one-card machine) takes gloo.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def rank(group) -> int:
    return dist.get_rank(group)


def world(group) -> int:
    return dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """A new tensor: ``op`` over the ranks' ``t``."""
    out = t.detach().cpu().clone() if _staged(t, group) \
        else t.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out.to(t.device)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along dim 0 in rank
    order (a bool tensor travels as uint8)."""
    src = t.detach().cpu() if _staged(t, group) else t.detach()
    src = src.to(torch.uint8) if t.dtype == torch.bool else src
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(world(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=0).to(t.device, t.dtype)


def broadcast(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (``t`` gives the shape and
    dtype)."""
    out = t.detach().cpu().clone() if _staged(t, group) \
        else t.detach().clone().contiguous()
    dist.broadcast(out, src=dist.get_global_rank(group, src), group=group)
    return out.to(t.device)


def shift(t: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """One step of a ring: send ``t`` to rank + ``step`` and return what
    rank - ``step`` sent (equal shapes), by ``batch_isend_irecv``."""
    D, r = world(group), rank(group)
    staged = _staged(t, group)
    src = t.detach().cpu().contiguous() if staged else t.detach().contiguous()
    out = torch.empty_like(src)
    def peer(j):
        return dist.get_global_rank(group, j % D)

    ops: List = [dist.P2POp(dist.isend, src, peer(r + step), group),
                 dist.P2POp(dist.irecv, out, peer(r - step), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device)


class AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, replicated; its backward hands each rank
    the upstream gradient unchanged. Right where every rank computes the
    same loss of the replicated sum: each rank's own terms then take that
    loss's gradient, as they would in one process holding all terms."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None
