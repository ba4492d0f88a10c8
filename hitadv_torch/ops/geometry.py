"""Point-cloud geometry of the ported paths.

Port of the parts of `hitadv_tpu/ops/geometry.py` that HiT-ADV, the CW,
FGM, SaliencyDrop and GeoA3 attacks, the defenses, DGCNN, PointNet++, PCT
and PointConv run: distances (and the self distance matrix), gathers (by
rows and grouped neighbours-major) and their scatter-add transposes, kNN
(coordinate and feature space), farthest point sampling, the ball query,
the set-abstraction front ends, the graph max-pool, PointConv's KDE
density, the lower median and the Gaussian-kernel blend (from the clouds
through the field or through the fused kernel pair, or from the hoisted
field through its kernel pair). Clouds are ``[B, N, C]``.

`index_points`, `gather_group_nm`, `knn_points`, `knn_idx`,
`farthest_point_sample`, `query_ball_point`, `graph_max_pool`,
`kde_density`, `gaussian_blend_negdt` and `gaussian_blend_fused` go
through the hand-written kernels of `ops/kernels.py` (the kernel on a
CUDA tensor, its plain version on a CPU tensor), in both directions.
The rest is plain PyTorch, as it is plain XLA in the reference.

The helpers of PointNet++'s feature propagation and of the pointnet2_ops
API (`three_nn`, `three_interpolate`, `interpolate_weights`,
`group_points`, `knn_gather`) are compositions of those: the kNN and the
row gather, in both directions.

The contract checks of the reference (:53-72) raise on a cloud of the
wrong rank or dtype and on float indices, where the reference raises,
from shapes and dtypes alone (no device sync). They are always on: the
reference's ``set_validation`` switch is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from hitadv_torch.ops import kernels as K

# ---------------------------------------------------------------------------
# Input validation (reference :40-72, the CUDA lib's CHECK_* analogue)
# ---------------------------------------------------------------------------

def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``float32``), as the reference's
    messages print it."""
    return str(dtype).removeprefix("torch.")


def _check_cloud(x: torch.Tensor, name: str, rank: int = 3) -> None:
    if x.dim() != rank:
        raise ValueError(
            f"{name}: expected rank-{rank} [B, N, C], got {tuple(x.shape)}")
    if not x.dtype.is_floating_point:
        raise TypeError(
            f"{name}: expected float dtype, got {_dtype_name(x.dtype)}")


def _check_idx(idx: torch.Tensor, name: str) -> None:
    if idx.dtype.is_floating_point or idx.dtype.is_complex \
            or idx.dtype == torch.bool:
        raise TypeError(
            f"{name}: expected int dtype, got {_dtype_name(idx.dtype)}")


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``[B, N, C], [B, M, C] -> [B, N, M]`` squared distances,
    ``|s|^2 - 2 s.d + |d|^2`` with a full-f32 product (reference :75-98;
    TF32 is off package-wide)."""
    _check_cloud(src, "square_distance:src")
    _check_cloud(dst, "square_distance:dst")
    inner = torch.matmul(src, dst.transpose(-1, -2))
    s2 = torch.sum(src * src, dim=-1, keepdim=True)          # [B, N, 1]
    d2 = torch.sum(dst * dst, dim=-1, keepdim=True)          # [B, M, 1]
    return s2 - 2.0 * inner + d2.transpose(-1, -2)


def pairwise_distance(points: torch.Tensor) -> torch.Tensor:
    """Self squared-distance matrix ``[B, N, N]`` (reference :101-108)."""
    return square_distance(points, points)


# ---------------------------------------------------------------------------
# Gather
# ---------------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    """Row gather whose backward is the row scatter-add (reference
    `_gather_rows_bwd`, :227-231), both through the kernels."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n_points = x.shape[1]
        return K.gather_rows(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return K.scatter_add_rows(idx, g.contiguous(), ctx.n_points), None


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points[b, idx[b, ...], :]`` for idx ``[B, S]`` or ``[B, S, K]``
    -> ``[B, *idx.shape[1:], C]`` (reference :110-136), through the
    gather kernel on CUDA."""
    _check_cloud(points, "index_points:points")
    _check_idx(idx, "index_points:idx")
    B, _, C = points.shape
    out = _GatherRows.apply(points.contiguous(),
                            idx.reshape(B, -1).contiguous())
    return out.reshape(*idx.shape, C)


def knn_gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pytorch3d's ``knn_gather``: ``[B, N, C], [B, S, K] -> [B, S, K, C]``
    (reference :291-301), `index_points`."""
    return index_points(points, idx)


class _GatherGroup(torch.autograd.Function):
    """Grouped gather whose backward is the grouped scatter-add (reference
    `_gather_group_bwd`, :179-183), both through the kernels; the
    neighbours-major cotangent is read in place."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n_points = x.shape[1]
        return K.gather_group(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return K.scatter_add_group(idx, g.contiguous(), ctx.n_points), None


def gather_group_nm(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Grouped gather, neighbours-major: ``out[b, j, s, :] = points[b,
    idx[b, s, j], :]`` for idx ``[B, S, ns]`` -> ``[B, ns, S, C]``
    (reference :139-165), so the neighbour reduction runs over axis 1."""
    _check_cloud(points, "gather_group_nm:points")
    _check_idx(idx, "gather_group_nm:idx")
    return _GatherGroup.apply(points.contiguous(), idx.contiguous())


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
    points' share of that VJP is a row scatter-add, computed only when
    the points need a gradient (an adv->ori Chamfer's ``ori`` does not)."""

    @staticmethod
    def forward(ctx, query, points, k):
        dists, idx = K.knn(query.contiguous(), points.contiguous(), k)
        ctx.save_for_backward(query, points, idx)
        ctx.mark_non_differentiable(idx)
        return dists, idx

    @staticmethod
    def backward(ctx, g_d, _g_idx):
        query, points, idx = ctx.saved_tensors
        neighbors = index_points(points.float(), idx)        # [B, S, K, C]
        diff = query.float()[:, :, None, :] - neighbors
        gq = gp = None
        if ctx.needs_input_grad[0]:
            gq = torch.sum(2.0 * g_d[..., None] * diff, dim=2).to(query.dtype)
        if ctx.needs_input_grad[1]:
            B, N, C = points.shape
            contrib = -2.0 * g_d[..., None] * diff
            gp = K.scatter_add_rows(idx.reshape(B, -1),
                                    contrib.reshape(B, -1, C).contiguous(),
                                    N).to(points.dtype)
        return gq, gp, None


def knn_points(query: torch.Tensor, points: torch.Tensor,
               k: int) -> KNNResult:
    """k nearest points of each query, ascending, lowest-index ties
    (reference :389-401, exact kNN kernel)."""
    dists, idx = _KNN.apply(query, points, k)
    return KNNResult(dists=dists, idx=idx)


def knn_idx(query: torch.Tensor, points: torch.Tensor,
            k: int) -> torch.Tensor:
    """Neighbour indices only ``[B, S, k]`` int32, ascending, lowest-index
    ties, self included when the query is a point (reference :404-434).
    Outside autograd, as the reference's ``stop_gradient``: indices are
    piecewise constant, so nothing flows back through them. Any C up to
    256, f32 or bf16; distances in f32 from the exactly widened inputs."""
    with torch.no_grad():
        _, idx = K.knn(query.detach().contiguous(),
                       points.detach().contiguous(), k)
    return idx


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
                          start: Union[int, torch.Tensor] = 0
                          ) -> torch.Tensor:
    """Greedy max-min sampling ``[B, N, 3] -> [B, npoint]`` int32
    (reference :460-509). Each cloud starts at its entry of ``start``, a
    ``[B]`` int32 tensor (the attacks draw it uniformly), or every cloud
    at the index ``start``."""
    _check_cloud(xyz, "farthest_point_sample:xyz")
    B, N, _ = xyz.shape
    if not torch.is_tensor(start):
        if not 0 <= start < N:
            raise ValueError(f"start={start} outside [0, {N})")
        start = torch.full((B,), start, dtype=torch.int32,
                           device=xyz.device)
    return K.fps(xyz.contiguous(), npoint, start)


# ---------------------------------------------------------------------------
# Ball query and the set-abstraction front ends (PointNet++ / PCT)
# ---------------------------------------------------------------------------

def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """Up to ``nsample`` indices within ``radius`` of each centre
    ``[B, S, nsample]`` int32, ascending, padded with the first in-ball
    index, an empty ball clamped to N - 1 (reference :533-574). Outside
    autograd, as the reference's ``stop_gradient``."""
    _check_cloud(xyz, "query_ball_point:xyz")
    _check_cloud(new_xyz, "query_ball_point:new_xyz")
    with torch.no_grad():
        return K.ball_query(xyz.detach().float().contiguous(),
                            new_xyz.detach().float().contiguous(), radius,
                            nsample)


def sample_and_group(npoint: int, radius: float, nsample: int,
                     xyz: torch.Tensor, points: Optional[torch.Tensor],
                     concat: bool = True):
    """FPS from index 0 -> ball query -> gather -> centre-subtract ->
    feature concat (reference :581-621). ``concat=False`` returns
    ``(grouped_xyz_norm, grouped_points)`` for `linear_parts`. Returns
    (new_xyz ``[B, npoint, 3]``, new_points ``[B, npoint, nsample, 3 +
    D]``)."""
    fps_idx = farthest_point_sample(xyz, npoint)
    new_xyz = index_points(xyz, fps_idx)                     # [B, S, 3]
    idx = query_ball_point(radius, nsample, xyz, new_xyz)
    grouped_xyz = index_points(xyz, idx)                     # [B, S, ns, 3]
    grouped_xyz_norm = grouped_xyz - new_xyz[:, :, None, :]
    if points is not None:
        grouped_points = index_points(points, idx)
        if concat:
            new_points = torch.cat([grouped_xyz_norm, grouped_points], -1)
        else:
            new_points = (grouped_xyz_norm, grouped_points)
    else:
        new_points = grouped_xyz_norm
    return new_xyz, new_points


def sample_and_group_all(xyz: torch.Tensor, points: Optional[torch.Tensor],
                         concat: bool = True):
    """A single global group (reference :624-643): new_xyz zeros
    ``[B, 1, 3]``, the points ``[B, 1, N, 3 + D]`` (or the two parts
    with ``concat=False``)."""
    B, _, C = xyz.shape
    new_xyz = torch.zeros((B, 1, C), dtype=xyz.dtype, device=xyz.device)
    grouped_xyz = xyz[:, None, :, :]
    if points is None:
        return new_xyz, grouped_xyz
    if concat:
        return new_xyz, torch.cat([grouped_xyz, points[:, None]], dim=-1)
    return new_xyz, (grouped_xyz, points[:, None])


def knn_point(nsample: int, xyz: torch.Tensor,
              new_xyz: torch.Tensor) -> torch.Tensor:
    """PCT's kNN group indices ``[B, S, nsample]`` int32 (reference
    :646-657), outside autograd."""
    return knn_idx(new_xyz, xyz, nsample)


def sample_and_group_knn(npoint: int, nsample: int, xyz: torch.Tensor,
                         points: torch.Tensor, concat: bool = True):
    """PCT's sample_and_group (reference :660-685), FPS from index 0: kNN
    groups, features ``concat([grouped - centre, centre (tiled)])``;
    ``concat=False`` returns ``(grouped_norm, centre [B, S, 1, D])`` for
    `linear_parts`."""
    fps_idx = farthest_point_sample(xyz, npoint)
    new_xyz = index_points(xyz, fps_idx)                     # [B, S, 3]
    new_points = index_points(points, fps_idx)               # [B, S, D]
    idx = knn_point(nsample, xyz, new_xyz)                   # [B, S, ns]
    grouped_norm = index_points(points, idx) - new_points[:, :, None, :]
    if not concat:
        return new_xyz, (grouped_norm, new_points[:, :, None, :])
    tiled = new_points[:, :, None, :].expand_as(grouped_norm)
    return new_xyz, torch.cat([grouped_norm, tiled], dim=-1)


# ---------------------------------------------------------------------------
# three_nn / three_interpolate (PointNet++ feature propagation) and the
# pointnet2_ops grouping
# ---------------------------------------------------------------------------

def three_nn(unknown: torch.Tensor, known: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3 nearest known points of each unknown point: (dists ``[B, N,
    3]``, idx ``[B, N, 3]`` int32), the distances Euclidean, not squared,
    as the CUDA ``three_nn`` returns them (reference :692-706), through
    the kNN kernel. At a distance of 0 the square root's derivative is
    infinite, as in the reference."""
    res = knn_points(unknown, known, 3)
    return torch.sqrt(torch.clamp_min(res.dists, 0.0)), res.idx


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """``sum_j points[b, idx[b, n, j]] * weight[b, n, j]``: ``[B, M, C],
    [B, N, 3], [B, N, 3] -> [B, N, C]`` (reference :709-724). The rows
    come through the gather kernel, whose backward is the row scatter."""
    gathered = index_points(points, idx)                     # [B, N, 3, C]
    return torch.sum(gathered * weight[..., None], dim=2)


def interpolate_weights(dists: torch.Tensor,
                        eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights ``recip / sum(recip)``, ``recip = 1 /
    (dists + eps)`` (reference :727-735; FP passes squared distances)."""
    recip = 1.0 / (dists + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pointnet2_ops' grouping, channels-last: ``[B, N, C], [B, S, ns] ->
    [B, S, ns, C]`` (reference :742-749), `index_points`."""
    return index_points(points, idx)


# ---------------------------------------------------------------------------
# Graph max-pool (DGCNN's EdgeConv neighbour reduction)
# ---------------------------------------------------------------------------

class _GraphMaxPool(torch.autograd.Function):
    """Forward: `kernels.graph_max_pool` (max and first-argmax slot).
    Backward: the cotangent of each (row, channel) goes to the neighbour
    in its slot, through `kernels.graph_max_pool_bwd` (reference custom
    VJP, :268-285)."""

    @staticmethod
    def forward(ctx, y, idx):
        mx, slot = K.graph_max_pool(y, idx)
        ctx.save_for_backward(idx, slot)
        ctx.n_points = y.shape[1]
        return mx

    @staticmethod
    def backward(ctx, g):
        idx, slot = ctx.saved_tensors
        return K.graph_max_pool_bwd(idx, slot, g.contiguous(),
                                    ctx.n_points), None


def graph_max_pool(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``mx[b, n, c] = max_j y[b, idx[b, n, j], c]`` (reference
    :247-259): the ``[B, N, k, C]`` neighbour tensor never exists. The
    gradient goes to the first slot attaining the max, as torch's max
    backward picks it."""
    return _GraphMaxPool.apply(y.contiguous(), idx.contiguous())


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


class _BlendNegdt(torch.autograd.Function):
    """The blend from the transposed field through the kernel pair
    (reference custom VJP, :896-951): the backward's kernel gives the
    cotangents of delta and pert; the field's own, plain PyTorch (the
    reference's :936-944), only when the field needs one, which inside
    the attack it never does."""

    @staticmethod
    def forward(ctx, negdt, delta, pert):
        ctx.save_for_backward(negdt, delta, pert)
        return K.gaussian_blend_negdt(negdt, delta, pert)

    @staticmethod
    def backward(ctx, g_num, g_deno):
        negdt, delta, pert = ctx.saved_tensors
        g_num, g_deno = g_num.contiguous(), g_deno.contiguous()
        g_negdt = g_delta = g_pert = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            g_delta, g_pert = K.gaussian_blend_negdt_bwd(
                negdt, delta, pert, g_num, g_deno)
        if ctx.needs_input_grad[0]:
            inv2d2 = (1.0 / (2.0 * delta * delta))[:, None, :]  # [B, 1, Cn]
            gker = torch.einsum("bnc,bjc->bnj", g_num, pert) \
                + g_deno[..., None]
            g_negdt = gker * torch.exp(negdt * inv2d2) * inv2d2
        return g_negdt, g_delta, g_pert


def gaussian_blend_negdt(negdt: torch.Tensor, delta: torch.Tensor,
                         pert: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`gaussian_blend` from the transposed field ``negdt =
    neg_gaussian_field(central, ori).transpose(1, 2)`` ``[B, N, Cn]``
    (reference :896-921), through `kernels.gaussian_blend_negdt` in both
    directions -> (num ``[B, N, 3]``, deno ``[B, N]``)."""
    return _BlendNegdt.apply(negdt.contiguous(), delta.contiguous(),
                             pert.contiguous())


class _BlendFused(torch.autograd.Function):
    """The blend from the clouds through the fused kernel pair (reference
    custom VJP, :954-992): the backward recomputes every term and gives
    the cotangents of all four inputs."""

    @staticmethod
    def forward(ctx, central, ori, delta, pert):
        ctx.save_for_backward(central, ori, delta, pert)
        return K.gaussian_blend_fused(central, ori, delta, pert)

    @staticmethod
    def backward(ctx, g_num, g_deno):
        grads = K.gaussian_blend_fused_bwd(*ctx.saved_tensors,
                                           g_num.contiguous(),
                                           g_deno.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def gaussian_blend_fused(central: torch.Tensor, ori: torch.Tensor,
                         delta: torch.Tensor, pert: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The memory-lean `gaussian_blend` (reference :954-971): the same
    (num ``[B, N, 3]``, deno ``[B, N]``) through
    `kernels.gaussian_blend_fused` in both directions, which never hold
    the ``[B, Cn, N]`` field; for shapes whose field does not fit."""
    return _BlendFused.apply(central.contiguous(), ori.contiguous(),
                             delta.contiguous(), pert.contiguous())


# ---------------------------------------------------------------------------
# KDE density (PointConv)
# ---------------------------------------------------------------------------

class _KDEDensity(torch.autograd.Function):
    """Forward and backward through the KDE kernel pair (reference custom
    VJP, :1006-1038); the bandwidth is a constant."""

    @staticmethod
    def forward(ctx, xyz, bandwidth):
        ctx.save_for_backward(xyz)
        ctx.bandwidth = bandwidth
        return K.kde_density(xyz, bandwidth)

    @staticmethod
    def backward(ctx, g):
        (xyz,) = ctx.saved_tensors
        gx = K.kde_density_bwd(xyz, ctx.bandwidth, g.float().contiguous())
        return gx.to(xyz.dtype), None


def kde_density(xyz: torch.Tensor, bandwidth: float) -> torch.Tensor:
    """PointConv's Gaussian KDE density ``[B, N, 3] -> [B, N]`` f32,
    ``mean_j exp(-|x_i - x_j|^2 / (2 bw^2)) / (2.5 bw)`` over the whole
    cloud (reference :1006-1022, `util/pointconv_util.py:209-219`). On
    CUDA neither direction stores the ``[B, N, N]`` Gaussian."""
    return _KDEDensity.apply(xyz.contiguous(), float(bandwidth))


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
