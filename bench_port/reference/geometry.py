"""Plain geometry of the reference: squared distances, kNN, farthest
point sampling, the ball query and row gathers, in float32 PyTorch.

Distances between coordinates take ``(|q|^2 - 2 q.p) + |p|^2`` with each
sum taken channel by channel, left to right, every operation rounded on
its own: the arithmetic of the original code's ``square_distance``,
written out so that it does not depend on how a library orders a sum.
Distances between wide features take the matrix product for the cross
term, as the original DGCNN's ``knn`` does. Ties go to the lower index
(a stable sort).
"""

from __future__ import annotations

import torch


def _left_sum(terms):
    it = iter(terms)
    out = next(it)
    for t in it:
        out = out + t
    return out


def sqdist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``[B, M, C], [B, N, C] -> [B, M, N]`` squared distances, channel by
    channel."""
    C = q.shape[-1]
    qn = _left_sum(q[..., c] * q[..., c] for c in range(C))
    pn = _left_sum(p[..., c] * p[..., c] for c in range(C))
    cross = _left_sum(q[:, :, None, c] * p[:, None, :, c] for c in range(C))
    return (qn[:, :, None] - 2.0 * cross) + pn[:, None, :]


def sqdist_mm(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Squared distances of wide features with the cross term as one
    matrix product."""
    qn = torch.sum(q * q, dim=-1)
    pn = torch.sum(p * p, dim=-1)
    return qn[:, :, None] - 2.0 * torch.matmul(q, p.transpose(1, 2)) \
        + pn[:, None, :]


def knn(q: torch.Tensor, p: torch.Tensor, k: int, dist=sqdist):
    """``(dists [B, M, k], idx [B, M, k])`` of the k nearest points of
    each query, ascending, ties to the lower index."""
    d = dist(q, p)
    dists, idx = torch.sort(d, dim=-1, stable=True)
    return dists[..., :k], idx[..., :k]


def self_knn(pc: torch.Tensor, k: int):
    """The k nearest other points of every point: k + 1 neighbours, the
    first (the point itself) dropped."""
    dists, idx = knn(pc, pc, k + 1)
    return dists[..., 1:], idx[..., 1:]


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, ...], :]`` for x ``[B, N, C]``."""
    B, C = x.shape[0], x.shape[-1]
    flat = idx.reshape(B, -1, 1).long().expand(-1, -1, C)
    return torch.gather(x, 1, flat).reshape(*idx.shape, C)


def fps(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    """Greedy farthest point sampling from ``start`` ``[B]``: every
    point's distance to the chosen set starts at 1e10, each step takes
    the first point of largest distance."""
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    dist = torch.full((B, N), 1e10, device=xyz.device)
    far = start.long()
    out = []
    for _ in range(npoint):
        out.append(far)
        c = xyz[rows, far]
        d = ((xyz[..., 0] - c[:, 0:1]) * (xyz[..., 0] - c[:, 0:1])
             + (xyz[..., 1] - c[:, 1:2]) * (xyz[..., 1] - c[:, 1:2])) \
            + (xyz[..., 2] - c[:, 2:3]) * (xyz[..., 2] - c[:, 2:3])
        dist = torch.minimum(dist, d)
        far = torch.argmax(dist, dim=1)
    return torch.stack(out, dim=1)


def ball_query(xyz: torch.Tensor, centres: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """The first ``nsample`` indices within ``radius`` of each centre, in
    ascending order, padded with the first one; an empty ball gives the
    last index. The radius is squared in double and rounded once to f32."""
    N = xyz.shape[1]
    r2 = torch.tensor(float(radius) ** 2, dtype=torch.float32).item()
    d = sqdist(centres, xyz)
    col = torch.arange(N, device=xyz.device)
    key = torch.where(d <= r2, col, N)
    key = torch.sort(key, dim=-1).values[..., :nsample]
    key = torch.where(key == N, key[..., :1], key)
    return torch.clamp_max(key, N - 1)
