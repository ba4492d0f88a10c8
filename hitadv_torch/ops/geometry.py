"""Point-cloud geometry of the HiT-ADV main path.

Port of the parts of `hitadv_tpu/ops/geometry.py` the flagship attack
runs: distances, gathers, kNN, farthest point sampling, the lower median
and the Gaussian-kernel blend. Clouds are ``[B, N, C]``.

`index_points`, `knn_points` and `farthest_point_sample` go through the
hand-written kernels of `ops/kernels.py` (the kernel on a CUDA tensor,
its plain version on a CPU tensor). The rest is plain PyTorch, as it is
plain XLA in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from hitadv_torch.ops import kernels as K


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``[B, N, C], [B, M, C] -> [B, N, M]`` squared distances,
    ``|s|^2 - 2 s.d + |d|^2`` with a full-f32 product (reference :75-98;
    TF32 is off package-wide)."""
    inner = torch.matmul(src, dst.transpose(-1, -2))
    s2 = torch.sum(src * src, dim=-1, keepdim=True)          # [B, N, 1]
    d2 = torch.sum(dst * dst, dim=-1, keepdim=True)          # [B, M, 1]
    return s2 - 2.0 * inner + d2.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Gather
# ---------------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    """Row gather whose backward is the scatter-add. The CUDA scatter-add
    is the `scatter_add_rows` kernel, not ported yet; the main path never
    differentiates a gather."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n_points = x.shape[1]
        return K.gather_rows(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if g.is_cuda:
            raise NotImplementedError(
                "index_points backward on CUDA needs the scatter_add_rows "
                "kernel (pallas_kernels.py:1942), which is not ported yet")
        B, _, C = g.shape
        out = torch.zeros((B, ctx.n_points, C), dtype=g.dtype,
                          device=g.device)
        flat = (idx.long() + ctx.n_points
                * torch.arange(B, device=g.device)[:, None]).reshape(-1)
        out.view(-1, C).index_add_(0, flat, g.reshape(-1, C))
        return out, None


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points[b, idx[b, ...], :]`` for idx ``[B, S]`` or ``[B, S, K]``
    -> ``[B, *idx.shape[1:], C]`` (reference :110-136), through the
    gather kernel on CUDA."""
    B, _, C = points.shape
    out = _GatherRows.apply(points.contiguous(),
                            idx.reshape(B, -1).contiguous())
    return out.reshape(*idx.shape, C)


# ---------------------------------------------------------------------------
# kNN
# ---------------------------------------------------------------------------

class KNNResult(NamedTuple):
    """pytorch3d-compatible kNN result: squared dists + indices."""
    dists: torch.Tensor   # [B, S, K] squared distances, ascending
    idx: torch.Tensor     # [B, S, K] int32


class _KNN(torch.autograd.Function):
    """kNN with the squared-distance VJP of the reference
    (`_knn_pallas_bwd`, :359-383); the indices carry no gradient. The
    points' share of that VJP is a scatter-add: on CUDA it waits for the
    `scatter_add_rows` kernel, as the gather's backward does."""

    @staticmethod
    def forward(ctx, query, points, k):
        dists, idx = K.knn(query.contiguous(), points.contiguous(), k)
        ctx.save_for_backward(query, points, idx)
        ctx.mark_non_differentiable(idx)
        return dists, idx

    @staticmethod
    def backward(ctx, g_d, _g_idx):
        query, points, idx = ctx.saved_tensors
        if g_d.is_cuda:
            raise NotImplementedError(
                "knn_points backward on CUDA needs the scatter_add_rows "
                "kernel (pallas_kernels.py:1942), which is not ported yet")
        neighbors = index_points(points.float(), idx)        # [B, S, K, C]
        diff = query.float()[:, :, None, :] - neighbors
        gq = torch.sum(2.0 * g_d[..., None] * diff, dim=2)
        contrib = -2.0 * g_d[..., None] * diff
        B, N, C = points.shape
        flat = (idx.long() + N * torch.arange(B, device=idx.device)
                [:, None, None]).reshape(-1)
        gp = torch.zeros((B * N, C), dtype=torch.float32, device=idx.device)
        gp.index_add_(0, flat, contrib.reshape(-1, C))
        return gq.to(query.dtype), gp.view(B, N, C).to(points.dtype), None


def knn_points(query: torch.Tensor, points: torch.Tensor,
               k: int) -> KNNResult:
    """k nearest points of each query, ascending, lowest-index ties
    (reference :389-401, exact kNN kernel)."""
    dists, idx = _KNN.apply(query, points, k)
    return KNNResult(dists=dists, idx=idx)


def knn_indices(points: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-kNN (reference :437-453): k+1 neighbours, then drop the first
    (the point itself) -> (sq dists, idx), each ``[B, N, k]``."""
    res = knn_points(points, points, k + 1)
    return res.dists[..., 1:], res.idx[..., 1:]


# ---------------------------------------------------------------------------
# Farthest point sampling
# ---------------------------------------------------------------------------

def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          generator: Optional[torch.Generator] = None,
                          start_idx: int = 0) -> torch.Tensor:
    """Greedy max-min sampling ``[B, N, 3] -> [B, npoint]`` int32
    (reference :460-509). With a ``generator`` each cloud starts at a
    uniform random index drawn from it (the attack convention);
    otherwise every cloud starts at ``start_idx``."""
    B, N, _ = xyz.shape
    if generator is not None:
        start = torch.randint(0, N, (B,), generator=generator,
                              device=xyz.device, dtype=torch.int32)
    else:
        if not 0 <= start_idx < N:
            raise ValueError(f"start_idx={start_idx} outside [0, {N})")
        start = torch.full((B,), start_idx, dtype=torch.int32,
                           device=xyz.device)
    return K.fps(xyz.contiguous(), npoint, start)


# ---------------------------------------------------------------------------
# Gaussian-kernel blend (HiT-ADV deformation field)
# ---------------------------------------------------------------------------

def neg_gaussian_field(central: torch.Tensor, ori: torch.Tensor
                       ) -> torch.Tensor:
    """``-|ori_n - central_j|`` -> ``[B, Cn, N]`` (reference :755-771):
    the broadcast-subtract distance (not the matmul form, which loses
    ~5e-5 to cancellation near d=0), with +1e-24 under the root."""
    diff = ori[:, None, :, :] - central[:, :, None, :]       # [B,Cn,N,3]
    return -torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-24)


def gaussian_blend(central: torch.Tensor, ori: torch.Tensor,
                   delta: torch.Tensor, pert: torch.Tensor,
                   negd: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``num[b,n,:] = sum_j pert[b,j,:] ker[b,j,n]``, ``deno[b,n] =
    sum_j ker[b,j,n]`` with ``ker = exp(-|ori_n - central_j| / (2
    delta_j^2))`` (reference :774-809). ``negd`` is the precomputed
    `neg_gaussian_field`, loop-invariant inside the attack."""
    if negd is None:
        negd = neg_gaussian_field(central, ori)
    return _blend_from_negd(negd, delta, pert)


def _blend_from_negd(negd: torch.Tensor, delta: torch.Tensor,
                     pert: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exp + contraction tail of `gaussian_blend` (reference
    :812-835): deno rides the same f32 contraction as num, through a
    ones column."""
    ker = torch.exp(negd / (2.0 * delta * delta)[..., None])  # [B, Cn, N]
    pert1 = torch.cat([pert, torch.ones_like(pert[..., :1])], dim=-1)
    nd = torch.einsum("bjc,bjn->bnc", pert1, ker)            # [B, N, 4]
    return nd[..., :3], nd[..., 3]


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------

def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``x / max(|x|_2, eps)`` (torch ``F.normalize``; reference :1045)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(n, eps)


def median_points(pc: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Coordinate-wise lower median (torch.median's convention for even
    counts; reference :1052-1061)."""
    n = pc.shape[dim]
    return torch.sort(pc, dim=dim).values.select(dim, (n - 1) // 2)
