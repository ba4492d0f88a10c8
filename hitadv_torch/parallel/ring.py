"""Ring-pass blockwise set distances for large point counts (port of
`hitadv_tpu/parallel/ring.py`).

The points axis is sharded over the ranks of a process group: each rank
holds a block of N/D points of each cloud, and the blocks of the other
cloud go round the ring (send to rank + 1, receive from rank - 1,
`comm.shift`) while each rank keeps the running minimum of its queries'
squared distances, the set-distance analogue of ring attention. No rank
holds more than ``[B, N/D, N/D]`` distances at once (none at all on the
card: each block's minimum is `geometry.knn_points` at k=1, the 1-NN
kernel).

Semantics are those of `losses.chamfer_dist` / `losses.hausdorff_dist`:
the same distances, the lowest global index among equal minima, the
same reductions; the sums are taken per rank and then over the ranks,
so values and gradients agree within f32 rounding. Both functions take
the whole clouds (every rank the same) and return the replicated ``[B]``
result; their gradients with respect to either cloud are whole and
replicated too: the gradient of a rotated block travels back round the
ring to the rank that owns it, and the blocks' gradients are gathered.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from hitadv_torch.ops import geometry as G
from hitadv_torch.ops import kernels as K
from hitadv_torch.parallel import comm


class _Block(torch.autograd.Function):
    """This rank's block of the points axis of a whole, replicated cloud;
    the backward gathers the blocks' gradients into the whole one."""

    @staticmethod
    def forward(ctx, x, group):
        D, r = comm.world(group), comm.rank(group)
        N = x.shape[1]
        if N % D:
            raise ValueError(f"ring: {N} points are not divisible by the "
                             f"{D}-rank ring")
        ctx.group = group
        n = N // D
        return x[:, r * n:(r + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        whole = comm.all_gather(g.transpose(0, 1).contiguous(), ctx.group)
        return whole.transpose(0, 1).contiguous(), None


class _RingMins(torch.autograd.Function):
    """Per local query ``[B, n, 3]``, the squared distance to its nearest
    point of the whole other cloud, whose blocks ``[B, n, 3]`` go round
    the ring. Ties go to the lowest global index, as one 1-NN over the
    whole cloud. Backward: the queries' share locally; the points' share
    accumulated round the ring the other way, each rank adding its
    queries' share to the block it held at that step, until each block's
    sum reaches its owner."""

    @staticmethod
    def forward(ctx, q, p, group):
        D, r = comm.world(group), comm.rank(group)
        B, n, _ = q.shape
        block = p.detach()
        best = torch.full((B, n), float("inf"), device=q.device)
        best_at = torch.zeros((B, n), dtype=torch.int64, device=q.device)
        best_step = torch.zeros((B, n), dtype=torch.int64, device=q.device)
        best_idx = torch.zeros((B, n), dtype=torch.int32, device=q.device)
        nearest = torch.zeros_like(q)
        for s in range(D):
            nn = G.knn_points(q.detach(), block, 1)
            d, idx = nn.dists[..., 0], nn.idx[..., 0]
            at = idx.long() + ((r - s) % D) * block.shape[1]
            better = (d < best) | ((d == best) & (at < best_at))
            best = torch.where(better, d, best)
            best_at = torch.where(better, at, best_at)
            best_step = torch.where(better, s, best_step)
            best_idx = torch.where(better, idx, best_idx)
            nearest = torch.where(better[..., None],
                                  G.index_points(block, idx), nearest)
            if s < D - 1:
                block = comm.shift(block, group)
        ctx.save_for_backward(q, nearest, best_step, best_idx)
        ctx.group, ctx.n_points = group, p.shape[1]
        return best

    @staticmethod
    def backward(ctx, g):
        q, nearest, best_step, best_idx = ctx.saved_tensors
        diff = q.float() - nearest.float()
        gq = gp = None
        if ctx.needs_input_grad[0]:
            gq = (2.0 * g[..., None] * diff).to(q.dtype)
        if ctx.needs_input_grad[1]:
            D = comm.world(ctx.group)
            contrib = -2.0 * g[..., None] * diff
            for s in reversed(range(D)):
                mine = torch.where((best_step == s)[..., None], contrib,
                                   torch.zeros_like(contrib))
                part = K.scatter_add_rows(best_idx, mine, ctx.n_points)
                gp = part if gp is None else gp + part
                if s > 0:
                    gp = comm.shift(gp, ctx.group, step=-1)
            gp = gp.to(q.dtype)
        return gq, gp, None


class _RingMax(torch.autograd.Function):
    """The largest of the ranks' ``[B, n]`` values per example,
    replicated; the gradient is split evenly among the entries equal to
    it on every rank, as ``torch.amax`` splits it in one process."""

    @staticmethod
    def forward(ctx, x, group):
        top = comm.all_reduce(torch.amax(x, dim=1), group,
                              dist.ReduceOp.MAX)
        ties = x == top[:, None]
        count = comm.all_reduce(ties.sum(dim=1), group)
        ctx.save_for_backward(ties, count)
        return top

    @staticmethod
    def backward(ctx, g):
        ties, count = ctx.saved_tensors
        return g[:, None] * ties / count[:, None], None


def _directed(adv, ori, group, method):
    """The per-local-query minima each way that ``method`` asks for:
    (adv->ori ``[B, n]`` or None, ori->adv ``[B, n]`` or None)."""
    if method not in ("adv2ori", "ori2adv", "both"):
        raise ValueError(method)
    adv_l, ori_l = _Block.apply(adv, group), _Block.apply(ori, group)
    a2o = o2a = None
    if method in ("adv2ori", "both"):
        a2o = _RingMins.apply(adv_l, ori_l, group)
    if method in ("ori2adv", "both"):
        o2a = _RingMins.apply(ori_l, adv_l, group)
    return a2o, o2a


def _combine(a2o, o2a, method):
    if method == "both":
        return (a2o + o2a) / 2.0
    return a2o if method == "adv2ori" else o2a


def ring_chamfer(adv: torch.Tensor, ori: torch.Tensor, group,
                 method: str = "adv2ori") -> torch.Tensor:
    """`losses.chamfer_dist(adv, ori, method)` with the points axis
    sharded over ``group``'s ranks: adv, ori ``[B, N, 3]`` (every rank
    the whole clouds, N divisible by the group's size) -> the replicated
    ``[B]``."""
    a2o, o2a = _directed(adv, ori, group, method)

    def mean(mins, n_points):
        return comm.AllReduceSum.apply(torch.sum(mins, dim=1),
                                       group) / n_points

    return _combine(None if a2o is None else mean(a2o, adv.shape[1]),
                    None if o2a is None else mean(o2a, ori.shape[1]),
                    method)


def ring_hausdorff(adv: torch.Tensor, ori: torch.Tensor, group,
                   method: str = "adv2ori") -> torch.Tensor:
    """`losses.hausdorff_dist(adv, ori, method)` with the points axis
    sharded over ``group``'s ranks, as `ring_chamfer`."""
    a2o, o2a = _directed(adv, ori, group, method)
    return _combine(None if a2o is None else _RingMax.apply(a2o, group),
                    None if o2a is None else _RingMax.apply(o2a, group),
                    method)
