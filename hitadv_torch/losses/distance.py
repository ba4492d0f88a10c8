"""Curvature terms of HiT-ADV (port of `get_kappa` and `get_kappa_std`
from `hitadv_tpu/losses/distance.py`)."""

from __future__ import annotations

import torch

from hitadv_torch.ops import geometry as G


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


def get_kappa_std(pc: torch.Tensor, normal: torch.Tensor,
                  k: int = 10) -> torch.Tensor:
    """Unbiased std of kappa over each point's kNN ring (self excluded)."""
    _, idx = G.knn_indices(pc, k)
    kappa = _kappa(pc, normal, idx)                          # [B, N]
    B = kappa.shape[0]
    nn_kappa = torch.gather(kappa, 1, idx.reshape(B, -1).long()
                            ).reshape(idx.shape)             # [B, N, k]
    return torch.std(nn_kappa, dim=-1, correction=1)
