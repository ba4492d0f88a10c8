"""Shared attack pieces (port of `hitadv_tpu/attacks/base.py`): the
result type, the adversarial-loss selector, best-so-far bookkeeping, the
binary search over the loss weight, and a functional Adam.

Everything here stays on the device: masks and selections are
``torch.where``, never a branch on a tensor's value. The terms that
couple a batch's examples (loss means, whole-tensor min and max, random
draws) go through `parallel.shard`, so that a batch split over ranks
(`parallel.mesh.shard_attack`) gives each example what one process
gives it.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hitadv_torch.losses import (
    cross_entropy_loss,
    logits_adv_loss,
    untargeted_logits_adv_loss,
)
from hitadv_torch.parallel.shard import batch_draw


class AttackResult(NamedTuple):
    """What an attack returns (device tensors)."""
    adv_points: torch.Tensor   # [B, N, 3]
    success: torch.Tensor      # [B] bool
    pred: torch.Tensor         # [B] final adversarial prediction


def make_adv_fn(name: str, kappa: float = 0.0,
                targeted: bool = False) -> Callable:
    """'cross_entropy' | 'logits' -> a per-example ``[B]`` loss."""
    if name == "cross_entropy":
        return cross_entropy_loss
    if name == "logits":
        if targeted:
            return lambda lg, t: logits_adv_loss(lg, t, kappa)
        return lambda lg, t: untargeted_logits_adv_loss(lg, t, kappa)
    raise ValueError(f"unknown adv_func {name!r}")


class Draws:
    """An attack's random draws: pinned by the caller (``init_overrides``,
    a mapping of the draws ``keys`` to arrays, so that a run can be held
    against the JAX package's under the same draws) or drawn from the
    generator passed to each run."""

    def __init__(self, init_overrides: Optional[Mapping], keys, dev):
        self.dev = dev
        self.needed = bool(keys)
        self.pinned = {}
        if init_overrides is not None:
            missing = set(keys) - set(init_overrides)
            if missing:
                raise ValueError(f"init_overrides lacks {sorted(missing)}")
            self.pinned = {k: torch.as_tensor(init_overrides[k],
                                              dtype=torch.float32).to(dev)
                           for k in keys}

    def check(self, generator: Optional[torch.Generator]):
        if self.needed and not self.pinned and generator is None:
            raise ValueError("attack: pass a torch.Generator (or build the "
                             "attack with init_overrides)")

    def get(self, key: str, draw: Callable[[], torch.Tensor]):
        """The pinned ``key``, else ``draw()``."""
        return self.pinned[key] if self.pinned else draw()

    def noise(self, shape, generator, step: Optional[int] = None):
        """The 1e-7-scaled Gaussian start: the pinned ``"noise"`` (its
        ``step``-th entry when given), else a draw of ``shape``."""
        if self.pinned:
            noise = self.pinned["noise"]
            return noise if step is None else noise[step]
        return batch_draw(lambda s: torch.randn(
            s, generator=generator, device=self.dev), shape) * 1e-7


class BestState(NamedTuple):
    """Per-example best-so-far record."""
    dist: torch.Tensor    # [B]
    score: torch.Tensor   # [B] int32 (pred at best, -1 = none)
    adv: torch.Tensor     # [B, ...]

    @classmethod
    def init(cls, template: torch.Tensor) -> "BestState":
        B = template.shape[0]
        return cls(dist=torch.full((B,), 1e10, device=template.device),
                   score=torch.full((B,), -1, dtype=torch.int32,
                                    device=template.device),
                   adv=torch.zeros_like(template))


def update_best(best: BestState, ok: torch.Tensor, dist: torch.Tensor,
                pred: torch.Tensor, adv: torch.Tensor) -> BestState:
    """Masked ``ok & dist < best.dist`` update."""
    better = ok & (dist < best.dist)
    expand = better.reshape((-1,) + (1,) * (adv.dim() - 1))
    return BestState(dist=torch.where(better, dist, best.dist),
                     score=torch.where(better, pred.to(torch.int32),
                                       best.score),
                     adv=torch.where(expand, adv, best.adv))


def binary_search_update(found: torch.Tensor, lower: torch.Tensor,
                         upper: torch.Tensor, weight: torch.Tensor):
    """Per-example weight bisection (`CW/Perturb.py:176-186`)."""
    lower = torch.where(found, torch.maximum(lower, weight), lower)
    upper = torch.where(found, upper, torch.minimum(upper, weight))
    return lower, upper, (lower + upper) / 2.0


class AdamState(NamedTuple):
    step: int              # steps taken (host-side: no device sync)
    mu: torch.Tensor       # first moment
    nu: torch.Tensor       # second moment


def adam_init(param: torch.Tensor) -> AdamState:
    return AdamState(step=0, mu=torch.zeros_like(param),
                     nu=torch.zeros_like(param))


def adam_update(grad: torch.Tensor, state: AdamState, param: torch.Tensor,
                lr: float, beta1: float = 0.9, beta2: float = 0.999,
                eps: float = 1e-8) -> Tuple[torch.Tensor, AdamState]:
    """One torch-style Adam step, written out line for line as the
    reference's: bias corrections ``1 - beta ** t`` in f32."""
    step = state.step + 1
    mu = beta1 * state.mu + (1.0 - beta1) * grad
    nu = beta2 * state.nu + (1.0 - beta2) * (grad * grad)
    t = np.float32(step)
    mu_hat = mu / float(np.float32(1.0) - np.float32(beta1) ** t)
    nu_hat = nu / float(np.float32(1.0) - np.float32(beta2) ** t)
    new_param = param - lr * mu_hat / (torch.sqrt(nu_hat) + eps)
    return new_param, AdamState(step=step, mu=mu, nu=nu)
