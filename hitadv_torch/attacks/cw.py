"""CW optimisation attacks: binary-search perturbation and the kNN
variants.

Port of `hitadv_tpu/attacks/cw.py` (reference `CW/Perturb.py:13-202`,
`CW/kNN.py:14-151`, `CW/UKNN.py:14-159`):
  * CW-Perturb: an outer binary search over per-example loss weights, an
    inner Adam loop, the best-so-far bookkeeping of each iterate before
    its step, and the last iterate for the examples that never succeed;
  * CW-kNN / CW-UKNN: plain Adam descent with the distance loss scaled by
    N and a clip (with the normals) after every step.

The reference's scans are Python loops here. Inside them nothing waits
for the device: no ``.item()``, no branch on a tensor; the bookkeeping is
``torch.where`` on device tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import torch

from hitadv_torch import resolve_device
from hitadv_torch.attacks.base import (
    AttackResult,
    BestState,
    adam_init,
    adam_update,
    binary_search_update,
    update_best,
)
from hitadv_torch.losses import l2_dist
from hitadv_torch.parallel.shard import batch_draw, batch_mean


@dataclass(frozen=True)
class CWConfig:
    """Hyperparameters of record (`FGM/CWPert_args.py:34-44`)."""
    attack_lr: float = 1e-2
    init_weight: float = 10.0
    max_weight: float = 80.0
    binary_step: int = 10
    num_iter: int = 100
    targeted: bool = True        # success is pred == target; else !=


def _loss_grad(loss_fn: Callable, adv: torch.Tensor):
    """``(d loss / d adv, aux)`` for ``loss_fn(adv) -> (loss, aux)``."""
    with torch.enable_grad():
        x = adv.detach().requires_grad_(True)
        loss, aux = loss_fn(x)
        (grad,) = torch.autograd.grad(loss, x)
    return grad, aux


def make_cw_perturb(logits_fn: Callable, adv_fn: Callable,
                    dist_fn: Optional[Callable] = None,
                    cfg: CWConfig = CWConfig(),
                    clip_fn: Optional[Callable] = None, *,
                    init_overrides: Optional[Mapping] = None,
                    device="cuda"):
    """CW perturbation attack with a binary search over the loss weight.

    Args:
      logits_fn: victim ``[B, N, 3] -> [B, classes]`` on ``device``.
      adv_fn: per-example adversarial loss ``(logits, target) -> [B]``.
      dist_fn: ``(adv, ori) -> [B]`` distance (default the global L2 of
        `eval.py`'s CW-Perturb).
      clip_fn: optional ``(adv, ori) -> adv`` after each step.
      init_overrides: optional ``{"noise": [S, B, N, 3]}`` pinning each
        binary step's 1e-7 initial noise (`CW/Perturb.py:79-80`), so that
        a run can be compared with the JAX package's under the same draws.
      device: where the attack runs; ``"cuda"`` unless the caller asks
        for the CPU.
    Returns:
      ``attack(points [B, N, >=3], labels [B], generator) ->
      AttackResult``; ``generator`` (a `torch.Generator` on ``device``)
      draws the noise and may be None only with ``init_overrides``.
    """
    dev = resolve_device(device)
    if dist_fn is None:
        dist_fn = l2_dist
    noise = None
    if init_overrides is not None:
        noise = torch.as_tensor(init_overrides["noise"],
                                dtype=torch.float32).to(dev)

    def success_of(pred, target):
        return (pred == target) if cfg.targeted else (pred != target)

    def attack(points, labels, generator: Optional[torch.Generator] = None
               ) -> AttackResult:
        if noise is None and generator is None:
            raise ValueError("attack: pass a torch.Generator (or build the "
                             "attack with init_overrides)")
        points = torch.as_tensor(points, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels).to(dev).long()
        ori = points[..., :3].contiguous()
        B = ori.shape[0]

        def loss_fn(weight):
            def f(adv):
                logits = logits_fn(adv)
                al = batch_mean(adv_fn(logits, labels))
                dl = batch_mean(dist_fn(adv, ori) * weight)
                return al + dl, logits
            return f

        lower = torch.zeros(B, device=dev)
        upper = torch.full((B,), cfg.max_weight, device=dev)
        weight = torch.full((B,), cfg.init_weight, device=dev)
        o_best = BestState.init(ori)
        adv = ori
        for step in range(cfg.binary_step):
            if noise is not None:
                adv = ori + noise[step]
            else:
                adv = ori + batch_draw(lambda s: torch.randn(
                    s, generator=generator, device=dev), ori.shape) * 1e-7
            opt = adam_init(adv)
            best = BestState.init(ori)
            f = loss_fn(weight)
            for _ in range(cfg.num_iter):
                grad, logits = _loss_grad(f, adv)
                with torch.no_grad():
                    # bookkeeping of the iterate before its step, in the
                    # reference's order (`CW/Perturb.py:122-141`)
                    pred = torch.argmax(logits, dim=-1)
                    dist_val = torch.sqrt(torch.sum((adv - ori) ** 2,
                                                    dim=(1, 2)))
                    ok = success_of(pred, labels)
                    best = update_best(best, ok, dist_val, pred, adv)
                    o_best = update_best(o_best, ok, dist_val, pred, adv)
                    adv, opt = adam_update(grad, opt, adv, cfg.attack_lr)
                    if clip_fn is not None:
                        adv = clip_fn(adv, ori)
            found = (success_of(best.score, labels) & (best.score != -1)
                     & (best.dist <= o_best.dist))
            lower, upper, weight = binary_search_update(found, lower, upper,
                                                        weight)

        # failures fall back to the last iterate (`CW/Perturb.py:191-196`)
        success = lower > 0.0
        adv_final = torch.where(success[:, None, None], o_best.adv, adv)
        with torch.no_grad():
            pred = torch.argmax(logits_fn(adv_final), dim=-1)
        return AttackResult(adv_points=adv_final, success=success,
                            pred=pred)

    return attack


@dataclass(frozen=True)
class CWKNNConfig:
    """Defaults of `CW/kNN.py:19-20`."""
    attack_lr: float = 1e-3
    num_iter: int = 2500
    targeted: bool = True       # CW-kNN: pred == target; CW-UKNN: !=


def make_cw_knn(logits_fn: Callable, adv_fn: Callable, dist_fn: Callable,
                clip_fn: Optional[Callable] = None,
                cfg: CWKNNConfig = CWKNNConfig(), *,
                init_noise=None, device="cuda"):
    """CW-kNN / CW-UKNN: Adam descent with a clip and projection after
    every step.

    Args:
      logits_fn, adv_fn: as for `make_cw_perturb`.
      dist_fn: ``(adv, ori) -> [B]``, typically `chamfer_knn_dist`; its
        batch mean is scaled by N (`CW/kNN.py:103-107`).
      clip_fn: optional ``(adv, ori, normal) -> adv``; ``normal`` is
        ``points[..., 3:6]`` or None (the CW-UKNN convention).
      init_noise: optional ``[B, N, 3]`` pinning the initial noise (the
        JAX package draws ``normal(key, shape) * 1e-7``). Adam normalises
        the tiny Chamfer gradient of points the victim ignores, so the
        noise's signs set their first step: comparing with the JAX run
        needs the same array.
      device: where the attack runs; ``"cuda"`` unless the caller asks
        for the CPU.
    Returns:
      ``attack(points, labels, generator) -> AttackResult``;
      ``generator`` may be None only with ``init_noise``.
    """
    dev = resolve_device(device)
    noise = None
    if init_noise is not None:
        noise = torch.as_tensor(init_noise, dtype=torch.float32).to(dev)

    def attack(points, labels, generator: Optional[torch.Generator] = None
               ) -> AttackResult:
        if noise is None and generator is None:
            raise ValueError("attack: pass a torch.Generator (or build the "
                             "attack with init_noise)")
        points = torch.as_tensor(points, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels).to(dev).long()
        ori = points[..., :3].contiguous()
        normal = points[..., 3:6] if points.shape[-1] >= 6 else None
        N = ori.shape[1]
        if noise is not None:
            adv = ori + noise
        else:
            adv = ori + batch_draw(lambda s: torch.randn(
                s, generator=generator, device=dev), ori.shape) * 1e-7

        def loss_fn(adv):
            logits = logits_fn(adv)
            al = batch_mean(adv_fn(logits, labels))
            return al + batch_mean(dist_fn(adv, ori)) * N, None

        opt = adam_init(adv)
        for _ in range(cfg.num_iter):
            grad, _ = _loss_grad(loss_fn, adv)
            with torch.no_grad():
                adv, opt = adam_update(grad, opt, adv, cfg.attack_lr)
                if clip_fn is not None:
                    adv = clip_fn(adv, ori, normal)
        with torch.no_grad():
            pred = torch.argmax(logits_fn(adv), dim=-1)
        success = (pred == labels) if cfg.targeted else (pred != labels)
        return AttackResult(adv_points=adv, success=success, pred=pred)

    return attack
