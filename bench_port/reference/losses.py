"""The attacks' objectives and the victim's logits and input gradient in
blocks of clouds (every term here is a sum over clouds, so the blocks add
up to the whole batch's)."""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Per-cloud cross-entropy ``[B]``."""
    return -torch.gather(torch.log_softmax(logits, dim=-1), 1,
                         labels[:, None])[:, 0]


def untargeted_margin(logits: torch.Tensor, labels: torch.Tensor,
                      kappa: float):
    """Carlini-Wagner's untargeted margin ``max(z_y - max_{j != y} z_j +
    kappa, 0)`` ``[B]`` (the other classes' maximum taken with the true
    class pushed down by 10000, as the original code has it)."""
    one_hot = torch.nn.functional.one_hot(labels, logits.shape[-1]).to(
        logits.dtype)
    real = torch.sum(one_hot * logits, dim=-1)
    other = torch.amax((1.0 - one_hot) * logits - one_hot * 10000.0, dim=-1)
    return torch.clamp_min(real - other + kappa, 0.0)


def logits_in_blocks(forward, params, config, x: torch.Tensor,
                     block: int) -> torch.Tensor:
    with torch.no_grad():
        return torch.cat([forward(params, x[i:i + block], config)
                          for i in range(0, x.shape[0], block)])


def loss_grad(forward, params, config, x: torch.Tensor, labels, loss,
              block: int):
    """``(logits, d mean_b loss(logits_b, labels_b) / dx)`` with the
    forward and backward run ``block`` clouds at a time."""
    B = x.shape[0]
    logits, grads = [], []
    for i in range(0, B, block):
        xb = x[i:i + block].detach().requires_grad_(True)
        with torch.enable_grad():
            lg = forward(params, xb, config)
            (g,) = torch.autograd.grad(loss(lg, labels[i:i + block]).sum() / B,
                                       xb)
        logits.append(lg.detach())
        grads.append(g)
    return torch.cat(logits), torch.cat(grads)
