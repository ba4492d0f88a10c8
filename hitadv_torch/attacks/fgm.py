"""The fast-gradient family: FGSM, FGM-L2, IFGSM, IFGM-L2, PGD, MIFGSM and
FGSM-RS (port of `hitadv_tpu/attacks/fgm.py`, reference `FGM/FGSM.py:
8-341` and `FGM/FGM_l2.py:8-189`).

All are untargeted (success is pred != label). Each step differentiates
the batch mean of the adversarial loss, so every cloud's gradient carries
a factor 1/B, which the sign and the L2 normalisation remove. The
iterative loops are Python loops with no host syncs. Clouds are clamped
to ``[-1, 1]``, the reference's unit-sphere data.

The random starts (the 1e-7 Gaussian of the iterative attacks, the
uniform start of PGD and FGSM-RS) come from the generator passed to the
attack, or are pinned by ``init_overrides`` so that a run can be held
against the JAX package's under the same draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import torch

from hitadv_torch import resolve_device
from hitadv_torch.attacks.base import AttackResult, Draws
from hitadv_torch.losses import clip_points_linf


@dataclass(frozen=True)
class FGMConfig:
    """Hyperparameters of record (`eval.py:32,37`; step rule `eval.py:78`)."""
    budget: float = 0.55
    num_iter: int = 100
    step_size: Optional[float] = None   # default: budget * 2 / num_iter
    mu: float = 1.0                     # MIFGSM momentum (`eval.py:36`)

    @property
    def step(self) -> float:
        return (self.step_size if self.step_size is not None
                else self.budget * 2.0 / self.num_iter)


def _grad(logits_fn: Callable, adv_fn: Callable, pc: torch.Tensor,
          labels: torch.Tensor) -> torch.Tensor:
    """One forward and backward: the gradient of the batch mean of the
    adversarial loss at ``pc``."""
    with torch.enable_grad():
        x = pc.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(
            torch.mean(adv_fn(logits_fn(x), labels)), x)
    return g


def _l2_normalised(g: torch.Tensor) -> torch.Tensor:
    """``g / (|g|_2 + 1e-9)`` per cloud."""
    norm = torch.sqrt(torch.sum(g ** 2, dim=(1, 2)))
    return g / (norm[:, None, None] + 1e-9)


def _finalize(logits_fn: Callable, pc: torch.Tensor,
              labels: torch.Tensor) -> AttackResult:
    with torch.no_grad():
        pred = torch.argmax(logits_fn(pc), dim=-1)
    return AttackResult(adv_points=pc, success=pred != labels, pred=pred)


def _uniform_start(draws: Draws, shape, budget: float, generator):
    """The uniform offset in ``[-budget, budget]`` of PGD and FGSM-RS: the
    pinned ``"start"``, else a draw."""
    def draw():
        u = torch.rand(shape, generator=generator, device=draws.dev)
        return u * (2.0 * budget) - budget
    return draws.get("start", draw)


def _maker(run: Callable, keys, init_overrides, device):
    """``attack(points [B, N, >=3], labels, generator=None) ->
    AttackResult`` around ``run(ori, labels, draws, generator)``."""
    dev = resolve_device(device)
    draws = Draws(init_overrides, keys, dev)

    def attack(points, labels, generator: Optional[torch.Generator] = None
               ) -> AttackResult:
        draws.check(generator)
        points = torch.as_tensor(points, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels).to(dev).long()
        return run(points[..., :3].contiguous(), labels, draws, generator)

    return attack


def make_fgsm(logits_fn: Callable, adv_fn: Callable,
              cfg: FGMConfig = FGMConfig(), *, device="cuda"):
    """One sign step of ``budget`` (reference `FGM/FGSM.py:71-103`)."""
    def run(ori, labels, draws, generator):
        g = _grad(logits_fn, adv_fn, ori, labels)
        adv = torch.clamp(ori + torch.sign(g) * cfg.budget, -1.0, 1.0)
        return _finalize(logits_fn, adv, labels)
    return _maker(run, (), None, device)


def make_fgm_l2(logits_fn: Callable, adv_fn: Callable,
                cfg: FGMConfig = FGMConfig(), *, device="cuda"):
    """One step of ``budget`` along the cloud's L2-normalised gradient
    (reference `FGM/FGM_l2.py:71-107`)."""
    def run(ori, labels, draws, generator):
        g = _l2_normalised(_grad(logits_fn, adv_fn, ori, labels))
        adv = torch.clamp(ori + g * cfg.budget, -1.0, 1.0)
        return _finalize(logits_fn, adv, labels)
    return _maker(run, (), None, device)


def _iterate(logits_fn, adv_fn, cfg: FGMConfig, normalize_l2: bool,
             pc: torch.Tensor, ori: torch.Tensor,
             labels: torch.Tensor) -> AttackResult:
    """The IFGSM / IFGM-L2 loop from ``pc``, clipped around ``ori``
    (reference `FGM/FGSM.py:106-177`)."""
    for _ in range(cfg.num_iter):
        g = _grad(logits_fn, adv_fn, pc, labels)
        step = (cfg.step * _l2_normalised(g) if normalize_l2
                else cfg.step * torch.sign(g))
        pc = torch.clamp(clip_points_linf(pc + step, ori, cfg.budget),
                         -1.0, 1.0)
    return _finalize(logits_fn, pc, labels)


def make_ifgsm(logits_fn: Callable, adv_fn: Callable,
               cfg: FGMConfig = FGMConfig(), *,
               init_overrides: Optional[Mapping] = None, device="cuda"):
    """Iterative FGSM from a 1e-7 Gaussian start, clipped around that
    start (reference `FGM/FGSM.py:106-177`). ``init_overrides``:
    ``{"noise": [B, N, 3]}``."""
    def run(ori, labels, draws, generator):
        pc0 = ori + draws.noise(ori.shape, generator)
        return _iterate(logits_fn, adv_fn, cfg, False, pc0, pc0, labels)
    return _maker(run, ("noise",), init_overrides, device)


def make_ifgm_l2(logits_fn: Callable, adv_fn: Callable,
                 cfg: FGMConfig = FGMConfig(), *,
                 init_overrides: Optional[Mapping] = None, device="cuda"):
    """Iterative L2 FGM (reference `FGM/FGM_l2.py:110-189`), as
    `make_ifgsm` with L2-normalised steps."""
    def run(ori, labels, draws, generator):
        pc0 = ori + draws.noise(ori.shape, generator)
        return _iterate(logits_fn, adv_fn, cfg, True, pc0, pc0, labels)
    return _maker(run, ("noise",), init_overrides, device)


def make_pgd(logits_fn: Callable, adv_fn: Callable,
             cfg: FGMConfig = FGMConfig(), *,
             init_overrides: Optional[Mapping] = None, device="cuda"):
    """IFGSM from a uniform(-budget, budget) start plus the 1e-7 Gaussian
    (reference `FGM/FGSM.py:260-300`). As in the reference, the clip is
    around that jittered start, not the clean cloud. ``init_overrides``:
    ``{"start": [B, N, 3], "noise": [B, N, 3]}``."""
    def run(ori, labels, draws, generator):
        init = ori + _uniform_start(draws, ori.shape, cfg.budget, generator)
        pc0 = init + draws.noise(ori.shape, generator)
        return _iterate(logits_fn, adv_fn, cfg, False, pc0, pc0, labels)
    return _maker(run, ("start", "noise"), init_overrides, device)


def make_mifgsm(logits_fn: Callable, adv_fn: Callable,
                cfg: FGMConfig = FGMConfig(), *,
                init_overrides: Optional[Mapping] = None, device="cuda"):
    """Momentum IFGSM (reference `FGM/FGSM.py:180-257`): the momentum
    accumulates ``mu m + g / (|g|_1 + 1e-9)``, and each step is the sign
    of the L2-normalised momentum, clipped around the 1e-7 Gaussian
    start. ``init_overrides``: ``{"noise": [B, N, 3]}``."""
    def run(ori, labels, draws, generator):
        pc0 = ori + draws.noise(ori.shape, generator)
        pc, m = pc0, torch.zeros_like(pc0)
        for _ in range(cfg.num_iter):
            g = _grad(logits_fn, adv_fn, pc, labels)
            l1 = torch.sum(torch.abs(g), dim=(1, 2))
            m = cfg.mu * m + g / (l1[:, None, None] + 1e-9)
            direction = torch.sign(_l2_normalised(m))
            pc = torch.clamp(clip_points_linf(pc + cfg.step * direction, pc0,
                                              cfg.budget), -1.0, 1.0)
        return _finalize(logits_fn, pc, labels)
    return _maker(run, ("noise",), init_overrides, device)


def make_fgsm_rs(logits_fn: Callable, adv_fn: Callable,
                 cfg: FGMConfig = FGMConfig(), *,
                 init_overrides: Optional[Mapping] = None, device="cuda"):
    """One sign step of ``budget`` from a uniform(-budget, budget) start,
    clipped around the clean cloud (reference `FGM/FGSM.py:303-341`,
    :310). ``init_overrides``: ``{"start": [B, N, 3]}``."""
    def run(ori, labels, draws, generator):
        init = ori + _uniform_start(draws, ori.shape, cfg.budget, generator)
        g = _grad(logits_fn, adv_fn, init, labels)
        adv = torch.clamp(clip_points_linf(init + torch.sign(g) * cfg.budget,
                                           ori, cfg.budget), -1.0, 1.0)
        return _finalize(logits_fn, adv, labels)
    return _maker(run, ("start",), init_overrides, device)
