"""One step of iterative FGSM (Kurakin et al., 2017; HiT-ADV's
`FGM/FGSM.py`): the sign of the gradient of the batch's mean
cross-entropy, a step of ``step`` along it, the perturbation clipped to
``budget`` in every coordinate around the start, and the cloud clamped
to ``[-1, 1]``."""

from __future__ import annotations

import torch

from bench_port.reference.losses import cross_entropy, loss_grad


def step(forward, params, config, pc: torch.Tensor, start: torch.Tensor,
         labels: torch.Tensor, step_size: float, budget: float,
         block: int) -> torch.Tensor:
    """The cloud after one step from ``pc``."""
    _, g = loss_grad(forward, params, config, pc, labels, cross_entropy,
                     block)
    moved = pc + step_size * torch.sign(g)
    return torch.clamp(start + torch.clamp(moved - start, -budget, budget),
                       -1.0, 1.0)
