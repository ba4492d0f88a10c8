"""Perturbation clipping and projection (port of
`hitadv_tpu/losses/clip.py`, reference `util/clip_utils.py`).

Clouds are ``[B, N, 3]``. The attacks apply these to the iterate outside
the differentiated graph.
"""

from __future__ import annotations

from typing import Optional

import torch


def clip_points_l2(pc: torch.Tensor, ori_pc: torch.Tensor,
                   budget: float) -> torch.Tensor:
    """Rescale each example's whole perturbation into an L2 ball."""
    diff = pc - ori_pc
    norm = torch.sqrt(torch.sum(diff ** 2, dim=(1, 2)))      # [B]
    scale = torch.clamp_max(budget / (norm + 1e-9), 1.0)
    return ori_pc + diff * scale[:, None, None]


def clip_points_linf(pc: torch.Tensor, ori_pc: torch.Tensor,
                     budget: float) -> torch.Tensor:
    """Clamp every coordinate of the perturbation to ``[-budget,
    budget]``."""
    return ori_pc + torch.clamp(pc - ori_pc, -budget, budget)


def project_inner_points(pc: torch.Tensor, ori_pc: torch.Tensor,
                         normal: Optional[torch.Tensor]) -> torch.Tensor:
    """Project points pushed inside the surface back onto it (AAAI'20).

    A point is inner when its perturbation opposes the normal; its
    perturbation becomes ``diff * vref / |vref|`` with ``vref = (n x
    diff) x n`` — an elementwise (Hadamard) product, as the reference's
    code has it (`util/clip_utils.py:122-124`), not the scalar projection
    its comment describes. Perturbations anti-parallel to the normal are
    zeroed."""
    if normal is None:
        return pc
    diff = pc - ori_pc                                       # [B, N, 3]
    inner_mask = torch.sum(diff * normal, dim=-1) < 0.0      # [B, N]
    vng = torch.linalg.cross(normal, diff, dim=-1)
    vng_norm = torch.linalg.vector_norm(vng, dim=-1)
    vref = torch.linalg.cross(vng, normal, dim=-1)
    vref_norm = torch.linalg.vector_norm(vref, dim=-1)
    diff_proj = diff * vref / (vref_norm[..., None] + 1e-9)
    opposite = inner_mask & (vng_norm < 1e-6)
    diff_proj = torch.where(opposite[..., None], 0.0, diff_proj)
    new_diff = torch.where(inner_mask[..., None], diff_proj, diff)
    return ori_pc + new_diff


def project_inner_clip_linf(pc: torch.Tensor, ori_pc: torch.Tensor,
                            budget: float,
                            normal: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Project inner points, then clip to the L-infinity budget."""
    return clip_points_linf(project_inner_points(pc, ori_pc, normal),
                            ori_pc, budget)
