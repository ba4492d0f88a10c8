"""Distance losses between point clouds (port of
`hitadv_tpu/losses/distance.py`): the L2, Chamfer, Hausdorff and kNN
outlier distances of the CW attacks, the Laplacian smoothness, the
distances of the Add attacks, the curvature terms of HiT-ADV and GeoA3,
the curvature-std distance of the evaluation, and CW-LPIPS's perceptual
distance.

Clouds are ``[B, N, 3]``; every loss returns a per-example ``[B]``
vector. The set distances run on the k=1 kNN (`geometry.knn_points`),
whose backward is the kNN kernel's gather and scatter-add on CUDA; the
``[B, N, N]`` matrix never exists.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from hitadv_torch.ops import geometry as G


def l2_dist(adv_pc: torch.Tensor, ori_pc: torch.Tensor) -> torch.Tensor:
    """Global L2 between clouds, ``sqrt(sum (adv - ori)^2 + 1e-7)``."""
    return torch.sqrt(torch.sum((adv_pc - ori_pc) ** 2, dim=(1, 2)) + 1e-7)


def _directed_mins(adv_pc: torch.Tensor, ori_pc: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min squared distance each way: (adv->ori ``[B, Na]``, ori->adv
    ``[B, No]``), as two 1-NN queries."""
    a2o = G.knn_points(adv_pc, ori_pc, 1).dists[..., 0]
    o2a = G.knn_points(ori_pc, adv_pc, 1).dists[..., 0]
    return a2o, o2a


def _set_reduce(adv_pc, ori_pc, method, reduce_fn):
    if method == "adv2ori":
        return reduce_fn(G.knn_points(adv_pc, ori_pc, 1).dists[..., 0], 1)
    if method == "ori2adv":
        return reduce_fn(G.knn_points(ori_pc, adv_pc, 1).dists[..., 0], 1)
    if method == "both":
        a2o, o2a = _directed_mins(adv_pc, ori_pc)
        return (reduce_fn(a2o, 1) + reduce_fn(o2a, 1)) / 2.0
    raise ValueError(method)


def chamfer_dist(adv_pc: torch.Tensor, ori_pc: torch.Tensor,
                 method: str = "adv2ori") -> torch.Tensor:
    """Chamfer distance: the mean of the nearest squared distances."""
    return _set_reduce(adv_pc, ori_pc, method, torch.mean)


def hausdorff_dist(adv_pc: torch.Tensor, ori_pc: torch.Tensor,
                   method: str = "adv2ori") -> torch.Tensor:
    """Hausdorff distance: the largest nearest squared distance (``amax``
    splits the gradient among exact ties, as jnp.max does)."""
    return _set_reduce(adv_pc, ori_pc, method, torch.amax)


def knn_dist(pc: torch.Tensor, k: int = 5,
             alpha: float = 1.05) -> torch.Tensor:
    """Mean-kNN outlier penalty (AAAI'20): per point the mean squared
    distance to its k nearest others; the points above ``mean + alpha
    std`` (unbiased std, a mask outside autograd) count."""
    dists, _ = G.knn_indices(pc, k)                          # [B, N, k]
    value = torch.mean(dists, dim=-1)                        # [B, N]
    mean = torch.mean(value, dim=-1, keepdim=True)
    std = torch.std(value, dim=-1, keepdim=True, correction=1)
    mask = (value > mean + alpha * std).to(pc.dtype).detach()
    return torch.mean(value * mask, dim=1)


def chamfer_knn_dist(adv_pc: torch.Tensor, ori_pc: torch.Tensor,
                     chamfer_method: str = "adv2ori", knn_k: int = 5,
                     knn_alpha: float = 1.05, chamfer_weight: float = 5.0,
                     knn_weight: float = 3.0) -> torch.Tensor:
    """``chamfer_weight * chamfer + knn_weight * knn_dist`` (the
    geometry-aware AAAI'20 combination of the CW-kNN attacks)."""
    cd = chamfer_dist(adv_pc, ori_pc, method=chamfer_method)
    kd = knn_dist(adv_pc, k=knn_k, alpha=knn_alpha)
    return cd * chamfer_weight + kd * knn_weight


def laplacian_dist(adv_pc: torch.Tensor, ori_pc: torch.Tensor,
                   nearest_indices: torch.Tensor) -> torch.Tensor:
    """Sum of the squared perturbation norms over each point's kNN ring
    ``nearest_indices`` ``[B, N, k]`` (reference `util/dist_utils.py:
    178-229`: the neighbours' perturbations, the centre's not subtracted,
    as the code has it)."""
    neigh = G.index_points(adv_pc - ori_pc, nearest_indices)  # [B,N,k,3]
    return torch.sum(neigh ** 2, dim=(1, 2, 3))


def farthest_dist(adv_clusters: torch.Tensor) -> torch.Tensor:
    """The largest distance inside each cluster, summed over the clusters
    (reference `util/dist_utils.py:297-325`); ``adv_clusters`` is ``[B,
    num_add, cl_num_p, 3]``. The 1e-7 is added to the difference, before
    the norm, as the reference has it; ``amax`` splits the gradient among
    exact ties, as jnp.max does."""
    delta = (adv_clusters[:, :, None, :, :]
             - adv_clusters[:, :, :, None, :] + 1e-7)
    norm = torch.linalg.vector_norm(delta, dim=-1)           # [B,na,np,np]
    far = torch.amax(torch.amax(norm, dim=2), dim=2)         # [B, na]
    return torch.sum(far, dim=1)


def far_chamfer_dist(adv_pc: torch.Tensor, ori_pc: torch.Tensor,
                     num_add: int) -> torch.Tensor:
    """Add-Cluster's distance: the clusters' compactness plus 0.1 times
    their added-to-original Chamfer proximity (reference
    `util/dist_utils.py:328-365`). ``adv_pc`` is the added points alone,
    ``[B, num_add * cl_num_p, 3]``."""
    cd = chamfer_dist(adv_pc, ori_pc, method="adv2ori")
    clusters = adv_pc.reshape(adv_pc.shape[0], num_add, -1, 3)
    return farthest_dist(clusters) + cd * 0.1


def l2_chamfer_dist(adv_pc: torch.Tensor, ori_pc: torch.Tensor,
                    adv_obj: torch.Tensor, ori_obj: torch.Tensor
                    ) -> torch.Tensor:
    """Add-Object's distance: the objects' L2 change plus 0.2 times the
    added-to-original Chamfer proximity of the placed points (reference
    `util/dist_utils.py:368-409`)."""
    B = adv_pc.shape[0]
    cd = chamfer_dist(adv_pc, ori_pc, method="adv2ori")
    l2 = l2_dist(adv_obj.reshape(B, -1, 3), ori_obj.reshape(B, -1, 3))
    return l2 + 0.2 * cd


def _kappa(pc: torch.Tensor, normal: torch.Tensor, idx: torch.Tensor
           ) -> torch.Tensor:
    nn_pts = G.index_points(pc, idx)                         # [B, N, k, 3]
    vectors = G.l2_normalize(nn_pts - pc[:, :, None, :], dim=-1)
    dots = torch.sum(vectors * normal[:, :, None, :], dim=-1)
    return torch.mean(torch.abs(dots), dim=-1)               # [B, N]


def get_kappa(pc: torch.Tensor, normal: torch.Tensor,
              k: int = 2) -> torch.Tensor:
    """Per-point curvature proxy: mean |<unit(q - p), n_p>| over the kNN
    ring (self excluded). ``pc``/``normal`` are ``[B, N, 3]``."""
    _, idx = G.knn_indices(pc, k)
    return _kappa(pc, normal, idx)


def get_kappa_adv(adv_pc: torch.Tensor, ori_pc: torch.Tensor,
                  ori_normal: torch.Tensor, k: int = 2
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kappa of the adversarial cloud with the normal of each point's
    nearest clean point (reference `FGM/GeoA3_args.py:161-182`): (kappa
    ``[B, N]``, normals ``[B, N, 3]``). The 1-NN's indices carry no
    gradient; the gradient flows through the gathers of `get_kappa`."""
    nn1 = G.knn_points(adv_pc, ori_pc, 1)
    normal = G.index_points(ori_normal, nn1.idx[..., 0])     # [B, N, 3]
    return get_kappa(adv_pc, normal, k), normal


def curv_dist(ori_pc: torch.Tensor, adv_pc: torch.Tensor,
              ori_normal: torch.Tensor, k: int = 2) -> torch.Tensor:
    """GeoA3's curvature consistency ``[B]``: the mean squared difference
    of each adversarial point's kappa and its nearest clean point's
    (reference `util/dist_utils.py:498-561`)."""
    ori_kappa = get_kappa(ori_pc, ori_normal, k)
    adv_kappa, _ = get_kappa_adv(adv_pc, ori_pc, ori_normal, k)
    nn1 = G.knn_points(adv_pc, ori_pc, 1)
    onenn = torch.gather(ori_kappa, 1, nn1.idx[..., 0].long())
    return torch.mean((adv_kappa - onenn) ** 2, dim=-1)


def get_kappa_std(pc: torch.Tensor, normal: torch.Tensor,
                  k: int = 10) -> torch.Tensor:
    """Unbiased std of kappa over each point's kNN ring (self excluded)."""
    _, idx = G.knn_indices(pc, k)
    kappa = _kappa(pc, normal, idx)                          # [B, N]
    B = kappa.shape[0]
    nn_kappa = torch.gather(kappa, 1, idx.reshape(B, -1).long()
                            ).reshape(idx.shape)             # [B, N, k]
    return torch.std(nn_kappa, dim=-1, correction=1)


def curv_std_dist(ori_pc: torch.Tensor, adv_pc: torch.Tensor,
                  ori_normal: torch.Tensor, k: int = 5) -> torch.Tensor:
    """L2 between the clean and adversarial kappa-std fields ``[B]`` (the
    imperceptibility metric; reference :236-245). Both fields take the
    clean normals, as the reference does."""
    ori_std = get_kappa_std(ori_pc, ori_normal, k)
    adv_std = get_kappa_std(adv_pc, ori_normal, k)
    return torch.linalg.vector_norm(ori_std - adv_std, dim=-1)


def normalize_flatten_features(features: Sequence[torch.Tensor],
                               eps: float = 1e-10) -> torch.Tensor:
    """Each ``[B, N, C]`` activation normalised over its channels, scaled
    by 1/sqrt(N) (the f32 square root, as jnp.sqrt of the point count),
    flattened, and all of them concatenated -> ``[B, sum N C]``
    (reference `util/dist_utils.py:564-592`, channels-last)."""
    out = []
    for f in features:
        norm = torch.sqrt(torch.sum(f ** 2, dim=-1, keepdim=True)) + eps
        root_n = float(np.sqrt(np.float32(f.shape[1])))
        out.append((f / (norm * root_n)).reshape(f.shape[0], -1))
    return torch.cat(out, dim=1)


def lpips_distance(features1: Sequence[torch.Tensor],
                   features2: Sequence[torch.Tensor]) -> torch.Tensor:
    """LPIPS between two activation stacks ``[B]`` (reference
    `util/dist_utils.py:412-461`)."""
    return torch.linalg.vector_norm(
        normalize_flatten_features(features1)
        - normalize_flatten_features(features2), dim=1)
