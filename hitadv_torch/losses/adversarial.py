"""Adversarial objectives (port of `hitadv_tpu/losses/adversarial.py`).

Per-example ``[B]`` losses; callers reduce.
"""

from __future__ import annotations

import torch


def _margin_parts(logits: torch.Tensor, targets: torch.Tensor):
    """Target logit and max-other logit with the ``±10000`` one-hot mask
    of the reference (`util/adv_utils.py:29-33`). ``amax`` splits the
    gradient among exact ties, as jnp.max does."""
    logits = logits.float()
    one_hot = torch.nn.functional.one_hot(
        targets.long(), logits.shape[-1]).to(logits.dtype)
    real = torch.sum(one_hot * logits, dim=-1)
    other = torch.amax((1.0 - one_hot) * logits - one_hot * 10000.0, dim=-1)
    return real, other


def _hinge(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, x.new_zeros(()))


def logits_adv_loss(logits: torch.Tensor, targets: torch.Tensor,
                    kappa: float = 0.0) -> torch.Tensor:
    """Targeted CW margin ``max(other - target + kappa, 0)``."""
    real, other = _margin_parts(logits, targets)
    return _hinge(other - real + kappa)


def untargeted_logits_adv_loss(logits: torch.Tensor, targets: torch.Tensor,
                               kappa: float = 0.0) -> torch.Tensor:
    """Untargeted CW margin ``max(true - other + kappa, 0)``."""
    real, other = _margin_parts(logits, targets)
    return _hinge(real - other + kappa)


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Per-example cross-entropy."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 1, targets.long()[:, None])[:, 0]


def smoothed_cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                                eps: float = 0.2) -> torch.Tensor:
    """Per-example label-smoothed cross-entropy, the DGCNN/PCT training
    loss (reference `model/pct_utils.py:6-24`, ``cal_loss`` with
    smoothing): the target class weighted ``1 - eps``, each other class
    ``eps / (K - 1)``."""
    logits = logits.float()
    K = logits.shape[-1]
    one_hot = torch.nn.functional.one_hot(targets.long(), K).to(
        logits.dtype)
    soft = one_hot * (1.0 - eps) + (1.0 - one_hot) * eps / (K - 1)
    return -torch.sum(soft * torch.log_softmax(logits, dim=-1), dim=-1)
