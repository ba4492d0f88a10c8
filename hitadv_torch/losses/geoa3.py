"""GeoA3's loss zoo, the disk-uniformity metric of the evaluation, and
the normal estimators (port of `hitadv_tpu/losses/geoa3.py`, reference
`FGM/GeoA3_args.py:113-425`).

Clouds are ``[B, N, 3]``. Per-point losses return ``[B, N]``, per-cloud
ones ``[B]``, `uniform_loss` a scalar. The set losses run on the k = 1
kNN (`geometry.knn_points`: the 1-NN kernel on the card, its backward a
gather and, for the clean-to-adversarial side, a row scatter-add).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from hitadv_torch.ops import geometry as G


# ---------------------------------------------------------------------------
# Set losses (kNN-based, GeoA3 variants)
# ---------------------------------------------------------------------------

def norm_l2_loss(adv_pc: torch.Tensor, ori_pc: torch.Tensor
                 ) -> torch.Tensor:
    """Squared L2 of the perturbation ``[B]`` (reference :113-114)."""
    return torch.sum((adv_pc - ori_pc) ** 2, dim=(1, 2))


def chamfer_loss(adv_pc: torch.Tensor, ori_pc: torch.Tensor
                 ) -> torch.Tensor:
    """Two-sided Chamfer, the sum of both sides' means ``[B]`` (reference
    :117-124)."""
    a2o = G.knn_points(adv_pc, ori_pc, 1).dists[..., 0]      # [B, N]
    o2a = G.knn_points(ori_pc, adv_pc, 1).dists[..., 0]
    return torch.mean(a2o, dim=-1) + torch.mean(o2a, dim=-1)


def pseudo_chamfer_loss(adv_pc: torch.Tensor, ori_pc: torch.Tensor
                        ) -> torch.Tensor:
    """One-sided Chamfer, adversarial to clean ``[B]`` (reference
    :127-133)."""
    return torch.mean(G.knn_points(adv_pc, ori_pc, 1).dists[..., 0], dim=-1)


def hausdorff_loss(adv_pc: torch.Tensor, ori_pc: torch.Tensor
                   ) -> torch.Tensor:
    """One-sided Hausdorff ``[B]`` (reference :136-141); ``amax`` splits
    the gradient among exact ties, as jnp.max does."""
    return torch.amax(G.knn_points(adv_pc, ori_pc, 1).dists[..., 0], dim=-1)


def curvature_loss(adv_pc: torch.Tensor, ori_pc: torch.Tensor,
                   adv_kappa: torch.Tensor, ori_kappa: torch.Tensor
                   ) -> torch.Tensor:
    """Each adversarial point's kappa against its nearest clean point's
    ``[B]`` (reference :184-197)."""
    nn1 = G.knn_points(adv_pc, ori_pc, 1)
    onenn = torch.gather(ori_kappa, 1, nn1.idx[..., 0].long())
    return torch.mean((adv_kappa - onenn) ** 2, dim=-1)


def _gather_rows_1d(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v[b, idx[b, n, j]]`` for v ``[B, N]`` and idx ``[B, N, k]``."""
    B = v.shape[0]
    return torch.gather(v, 1, idx.reshape(B, -1).long()).reshape(idx.shape)


def displacement_loss(adv_pc: torch.Tensor, ori_pc: torch.Tensor,
                      k: int = 16) -> torch.Tensor:
    """Smoothness of the squared displacement over the clean kNN graph
    ``[B, N]`` (reference :200-208)."""
    _, idx = G.knn_indices(ori_pc.detach(), k)
    theta = torch.sum((adv_pc - ori_pc) ** 2, dim=-1)        # [B, N]
    return torch.mean((_gather_rows_1d(theta, idx) - theta[:, :, None])
                      ** 2, dim=2)


def corresponding_normal_loss(adv_pc: torch.Tensor, normal: torch.Tensor,
                              k: int = 2) -> torch.Tensor:
    """Mean |<unit(q - p), n_p>| over the kNN ring ``[B, N]`` (reference
    :211-219)."""
    _, idx = G.knn_indices(adv_pc, k)
    nn_pts = G.index_points(adv_pc, idx)
    vectors = G.l2_normalize(nn_pts - adv_pc[:, :, None, :], dim=-1)
    dots = torch.sum(vectors * normal[:, :, None, :], dim=-1)
    return torch.mean(torch.abs(dots), dim=-1)


def repulsion_loss(pc: torch.Tensor, k: int = 4, h: float = 0.03
                   ) -> torch.Tensor:
    """Push points apart ``[B, N]`` (reference :222-226), on squared
    distances."""
    dists, _ = G.knn_indices(pc, k)
    return -torch.mean(dists * torch.exp(-(dists ** 2) / (h ** 2)), dim=2)


def distance_kmean_loss(pc: torch.Tensor, k: int) -> torch.Tensor:
    """Consistency of each point's mean kNN distance with its neighbours'
    ``[B, N]`` (reference :229-237), on the full distance matrix. The k + 1
    smallest distances come from a stable sort, so ties keep the lowest
    index first, as ``lax.top_k`` does (`torch.topk` does not promise it);
    the first, the point itself, is dropped. A point's distance to itself
    is NaN where the matmul form rounds its zero below -1e-12; it sorts
    first, as the JAX package's ``top_k`` of the negated distances puts
    it, so that it is still the one dropped."""
    d = torch.sqrt(G.pairwise_distance(pc) + 1e-12)
    srt = torch.sort(torch.where(torch.isnan(d), float("-inf"), d), dim=-1,
                     stable=True)
    dis = srt.values[..., 1:k + 1]
    idx = srt.indices[..., 1:k + 1]
    dis_mean = torch.mean(dis, dim=-1)                       # [B, N]
    return torch.mean(torch.abs(dis_mean[:, :, None]
                                - _gather_rows_1d(dis_mean, idx)), dim=-1)


def knn_smoothing_loss(adv_pc: torch.Tensor, k: int,
                       threshold_coef: float = 1.05) -> torch.Tensor:
    """Mean squared kNN distance of the outliers ``[B]`` (reference
    :240-255): unbiased std, the mask inside autograd (as the
    reference)."""
    dists, _ = G.knn_indices(adv_pc, k)
    knn_dis = torch.mean(dists, dim=-1)                      # [B, N]
    mean = torch.mean(knn_dis, dim=-1, keepdim=True)
    std = torch.std(knn_dis, dim=-1, keepdim=True, correction=1)
    cond = (knn_dis > mean + threshold_coef * std).to(adv_pc.dtype)
    return torch.mean(knn_dis * cond, dim=1)


PERCENTAGES = (0.004, 0.006, 0.008, 0.010, 0.012)


# ---------------------------------------------------------------------------
# Disk-uniformity metric (the evaluation's "Uniform dist")
# ---------------------------------------------------------------------------

def uniform_disks(n: int, percentages: Tuple[float, ...] = PERCENTAGES,
                  radius: float = 1.0) -> List[Tuple[float, int, float,
                                                     float]]:
    """``(p, nsample, r, expected spacing)`` of each disk of a cloud of
    ``n`` points: ``p`` four times the percentage, ``nsample = int(n p)``,
    ``r = sqrt(p radius)``. Disks with fewer than two points have no
    neighbour ring (below N ~ 128; the reference's NaN) and are left out."""
    disks = []
    for p in percentages:
        p = p * 4
        nsample = int(n * p)
        if nsample < 2:
            continue
        disks.append((p, nsample, math.sqrt(p * radius),
                      math.sqrt(math.pi * (radius ** 2) * p / nsample)))
    return disks


def uniform_loss(adv_pc: torch.Tensor,
                 percentages: Tuple[float, ...] = PERCENTAGES,
                 radius: float = 1.0, k: int = 2) -> torch.Tensor:
    """GeoA3 disk-uniformity loss (PU-GAN style), a scalar (reference
    :130-171): FPS of 5% of the points from index 0, then for each of
    `uniform_disks` a ball query of ``nsample`` points, the ``min(k + 1,
    nsample)`` nearest neighbours inside each disk (k clamped at the disk
    size, as the reference does), and the deviation of their mean spacing
    from the uniform spacing."""
    B, n, _ = adv_pc.shape
    npoint = int(n * 0.05)
    fps_idx = G.farthest_point_sample(adv_pc, npoint, start_idx=0)
    new_xyz = G.index_points(adv_pc, fps_idx)                # [B, S, 3]

    disks = uniform_disks(n, percentages, radius)
    loss = torch.zeros((), dtype=adv_pc.dtype, device=adv_pc.device)
    for p, nsample, r, expect_len in disks:
        idx = G.query_ball_point(r, nsample, adv_pc, new_xyz)
        grouped = G.index_points(adv_pc, idx)                # [B, S, ns, 3]
        flat = grouped.reshape(B * npoint, nsample, 3)
        knn = G.knn_points(flat, flat, min(k + 1, nsample))
        d = torch.sqrt(torch.abs(knn.dists[..., 1:]) + 1e-12)
        ud = torch.mean(d, dim=-1)                           # [B * S, ns]
        ud = ((ud - expect_len) ** 2) / (expect_len + 1e-12)
        loss = loss + torch.mean(ud) * (p * 100.0) ** 2
    return loss / max(len(disks), 1)


# ---------------------------------------------------------------------------
# Jitter and normal estimation
# ---------------------------------------------------------------------------

def jitter_input(generator: torch.Generator, shape, sigma: float = 0.01,
                 clip: float = 0.05, device=None) -> torch.Tensor:
    """Clamped Gaussian jitter ``clamp(sigma N(0, 1), -clip, clip)``
    (reference :308-313), drawn from ``generator`` (on ``device``, by
    default the generator's)."""
    dev = generator.device if device is None else device
    return torch.clamp(sigma * torch.randn(shape, generator=generator,
                                           device=dev), -clip, clip)


def _knn_ring_covariance(pc: torch.Tensor, k: int):
    """The centred covariance of each point's kNN ring ``[B, N, 3, 3]``,
    the ring ``[B, N, k, 3]``."""
    _, idx = G.knn_indices(pc, k)
    nn_pts = G.index_points(pc, idx)                         # [B, N, k, 3]
    centered = nn_pts - torch.mean(nn_pts, dim=2, keepdim=True)
    cov = torch.einsum("bnkc,bnkd->bncd", centered, centered) / (k - 1)
    return cov, nn_pts


def estimate_normal(pc: torch.Tensor, k: int) -> torch.Tensor:
    """PCA normals ``[B, N, 3]``: the smallest eigenvector of each kNN
    ring's covariance (`torch.linalg.eigh`, ascending), oriented against
    the point-to-centroid direction (reference :315-363 with the JAX
    package's fix of its sign). Outside autograd."""
    with torch.no_grad():
        cov, nn_pts = _knn_ring_covariance(pc, k)
        _, eigvec = torch.linalg.eigh(cov)
        normal = eigvec[..., 0]
        to_centroid = torch.mean(nn_pts, dim=2) - pc
        dot = torch.sum(normal * to_centroid, dim=-1, keepdim=True)
        return torch.where(dot > 0, -1.0, 1.0) * normal


def estimate_perpendicular(pc: torch.Tensor, k: int,
                           generator: Optional[torch.Generator] = None,
                           sigma: float = 0.01, clip: float = 0.05, *,
                           draws: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None
                           ) -> torch.Tensor:
    """A random jitter in each point's tangent plane ``[B, N, 3]``: the
    largest and second eigenvectors of its kNN ring's covariance, scaled
    by ``sigma N(0, 1)`` draws ``[B, N, 1]`` each, each term clamped to
    ``clip`` (reference :391-425). ``draws`` pins the two unit normal
    draws; else ``generator`` draws them. The eigenvectors are not
    oriented: either sign is an eigenvector, and `torch.linalg.eigh` and
    the reference's may differ in it."""
    B, N, _ = pc.shape
    cov, _ = _knn_ring_covariance(pc, k)
    _, eigvec = torch.linalg.eigh(cov)
    v1, v2 = eigvec[..., 2], eigvec[..., 1]
    if draws is None:
        draws = tuple(torch.randn((B, N, 1), generator=generator,
                                  device=pc.device) for _ in range(2))
    a1, a2 = (sigma * d for d in draws)
    return (torch.clamp(v1 * a1, -clip, clip)
            + torch.clamp(v2 * a2, -clip, clip))


def estimate_normal_via_ori_normal(pc_adv: torch.Tensor,
                                   pc_ori: torch.Tensor,
                                   normal_ori: torch.Tensor,
                                   k: int) -> torch.Tensor:
    """Clean normals carried to the adversarial points ``[B, N, 3]``: the
    normalised mean of the k nearest clean points' normals, or the
    nearest one's where the point has not moved (nearest squared
    distance below 1e-6; reference :366-382, normalised with keepdims as
    the JAX package does)."""
    knn = G.knn_points(pc_adv, pc_ori, k)
    normal_pts = G.index_points(normal_ori, knn.idx)         # [B, N, k, 3]
    avg = torch.mean(normal_pts, dim=2)
    avg = avg / (torch.linalg.vector_norm(avg, dim=-1, keepdim=True)
                 + 1e-12)
    cond = (knn.dists[..., 0] < 1e-6)[..., None]
    return torch.where(cond, normal_pts[:, :, 0, :], avg)
