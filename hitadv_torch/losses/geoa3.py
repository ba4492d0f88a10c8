"""The disk-uniformity metric of the evaluation (port of `uniform_loss`
in `hitadv_tpu/losses/geoa3.py`, reference `FGM/GeoA3_args.py:258-303`).

The rest of the JAX module (GeoA3's loss zoo and normal estimators) waits
for the GeoA3 attack. Clouds are ``[B, N, 3]``.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from hitadv_torch.ops import geometry as G


PERCENTAGES = (0.004, 0.006, 0.008, 0.010, 0.012)


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
