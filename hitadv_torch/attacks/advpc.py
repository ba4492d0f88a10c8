"""AdvPC and UAdvPC: the CW perturbation regularised by an autoencoder
(port of `hitadv_tpu/attacks/advpc.py`, reference `CW/AdvPC.py:10-180`
and `CW/UAdvPC.py:10-167`).

Each iteration descends two margin losses mixed by GAMMA, on the
adversarial cloud and on its AE reconstruction, clips, and keeps the
closest success:
  * targeted (AdvPC, `CW/AdvPC.py:142`): pred == target and the
    reconstruction's pred != the true label, both recomputed under
    no_grad on the clipped cloud after the step (`:111-124`); the attack
    is handed one label a cloud, which serves as both, as the JAX
    package's does without its ``y_truth``;
  * untargeted (UAdvPC, `CW/UAdvPC.py:111,129`): pred != label and the
    reconstruction's pred != label, from the forward's logits BEFORE the
    step, paired with the clipped coordinates after it (`:103-132`); with
    GAMMA < 0.001 the reconstruction's condition is dropped.
The binary steps are restarts (no weight schedule). The loops wait for
nothing on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import torch

from hitadv_torch import resolve_device
from hitadv_torch.attacks.base import (
    AttackResult,
    BestState,
    Draws,
    adam_init,
    adam_update,
    update_best,
)
from hitadv_torch.parallel.shard import batch_mean


@dataclass(frozen=True)
class AdvPCConfig:
    """Defaults of `CW/AdvPC.py:15-16`."""
    attack_lr: float = 1e-2
    binary_step: int = 2
    num_iter: int = 200
    gamma: float = 0.5
    targeted: bool = False


def make_advpc(logits_fn: Callable, ae_fn: Callable, adv_fn: Callable,
               clip_fn: Callable, cfg: AdvPCConfig = AdvPCConfig(), *,
               init_overrides: Optional[Mapping] = None, device="cuda"):
    """Build AdvPC (``cfg.targeted``) or UAdvPC.

    Args:
      logits_fn: victim ``[B, N, 3] -> [B, classes]`` on ``device``.
      ae_fn: autoencoder ``[B, N, 3] -> [B, N, 3]``.
      adv_fn: per-example margin loss in ``cfg.targeted``'s sense.
      clip_fn: ``(adv, ori) -> adv``, after every step and at the end.
      init_overrides: optional ``{"noise": [S, B, N, 3]}`` pinning each
        restart's 1e-7 noise (`CW/AdvPC.py:63-64`).
      device: where the attack runs; ``"cuda"`` unless the caller asks
        for the CPU.
    Returns:
      ``attack(points [B, N, >=3], labels, generator) -> AttackResult``;
      ``generator`` may be None only with ``init_overrides``.
    """
    dev = resolve_device(device)
    draws = Draws(init_overrides, ("noise",), dev)
    g = cfg.gamma

    def attack(points, labels, generator: Optional[torch.Generator] = None
               ) -> AttackResult:
        draws.check(generator)
        points = torch.as_tensor(points, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels).to(dev).long()
        ori = points[..., :3].contiguous()

        def loss_fn(adv):
            logits = logits_fn(adv)
            ae_logits = logits_fn(ae_fn(adv))
            loss = ((1.0 - g) * batch_mean(adv_fn(logits, labels))
                    + g * batch_mean(adv_fn(ae_logits, labels)))
            return loss, (logits, ae_logits)

        o_best = BestState.init(ori)
        adv = torch.zeros_like(ori)
        for step in range(cfg.binary_step):
            adv = ori + draws.noise(ori.shape, generator, step)
            opt = adam_init(adv)
            for _ in range(cfg.num_iter):
                with torch.enable_grad():
                    x = adv.detach().requires_grad_(True)
                    loss, (logits, ae_logits) = loss_fn(x)
                    (grad,) = torch.autograd.grad(loss, x)
                with torch.no_grad():
                    adv, opt = adam_update(grad, opt, adv, cfg.attack_lr)
                    adv = clip_fn(adv, ori)
                    dist = torch.sqrt(torch.sum((adv - ori) ** 2,
                                                dim=(1, 2)))
                    if cfg.targeted:
                        pred = torch.argmax(logits_fn(adv), dim=-1)
                        ae_pred = torch.argmax(logits_fn(ae_fn(adv)),
                                               dim=-1)
                        ok = (pred == labels) & (ae_pred != labels)
                    else:
                        pred = torch.argmax(logits, dim=-1)
                        ok = pred != labels
                        if g >= 0.001:                    # (:129)
                            ok = ok & (torch.argmax(ae_logits, dim=-1)
                                       != labels)
                    o_best = update_best(o_best, ok, dist, pred, adv)

        found = o_best.score >= 0
        adv_final = clip_fn(torch.where(found[:, None, None], o_best.adv,
                                        adv), ori)
        with torch.no_grad():
            pred = torch.argmax(logits_fn(adv_final), dim=-1)
        success = (pred == labels) if cfg.targeted else (pred != labels)
        return AttackResult(adv_points=adv_final, success=success,
                            pred=pred)

    return attack
