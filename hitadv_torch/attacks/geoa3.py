"""The GeoA3 attack, geometry-aware (CVPR'20 GeoA3; port of
`hitadv_tpu/attacks/geoa3.py`):

    loss = cross_entropy(logits, target)
         + weight * ( Chamfer (both sides)
                    + 0.1 * Hausdorff
                    + curvature (kappa with the nearest clean normals) )

with a CW-style outer binary search over the per-example weight (10
steps from 10) and Adam (lr 0.01) inside: the defaults of
`FGM/GeoA3_args.py:50-95`, the settings `hitadv_torch.eval` runs. The
JAX package's other options (a Margin loss, a one-sided Chamfer, other
loss weights, an L-inf projection, a jitter of the input each
iteration) have no caller in the port and are not ported.

The loops are Python loops with no host syncs; the best-so-far
bookkeeping stays on the device. Each distance term runs its own 1-NN,
as the reference's do.
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
    binary_search_update,
    make_adv_fn,
    update_best,
)
from hitadv_torch.losses.distance import get_kappa, get_kappa_adv
from hitadv_torch.losses.geoa3 import (
    chamfer_loss,
    curvature_loss,
    hausdorff_loss,
)
from hitadv_torch.parallel.shard import batch_mean

# the Hausdorff term's weight (`FGM/GeoA3_args.py`; Chamfer and curvature
# weigh 1)
HD_LOSS_WEIGHT = 0.1
# the binary search's first weight and ceiling (the CW convention)
INITIAL_CONST = 10.0
MAX_CONST = 80.0


@dataclass(frozen=True)
class GeoA3Config:
    """Defaults of `FGM/GeoA3_args.py:50-95`."""
    attack_lr: float = 0.01
    binary_max_steps: int = 10
    iter_max_steps: int = 500
    curv_loss_knn: int = 16
    targeted: bool = True            # attack_label All/<class> modes


def make_geoa3(logits_fn: Callable, cfg: GeoA3Config = GeoA3Config(), *,
               init_overrides: Optional[Mapping] = None, device="cuda"):
    """Build the GeoA3 attack.

    Args:
      logits_fn: victim ``[B, N, 3] -> [B, classes]`` on ``device``.
      cfg: the hyperparameters; ``targeted`` makes ``labels`` the target
        classes (success is pred == label), else the true ones.
      init_overrides: optional ``{"noise": [S, B, N, 3]}`` pinning each
        binary step's 1e-7-scaled Gaussian start, so that a run can be
        held against the JAX package's under the same draws.
      device: where the attack runs; ``"cuda"`` unless the caller asks
        for the CPU.
    Returns:
      ``attack(points [B, N, 6], labels, generator) -> AttackResult``:
      the normals ``points[..., 3:6]`` feed the curvature term.
      ``generator`` may be None only with ``init_overrides``.
    """
    dev = resolve_device(device)
    adv_fn = make_adv_fn("cross_entropy")
    draws = Draws(init_overrides, ("noise",), dev)

    def dist_terms(adv, ori, ori_normal, ori_kappa):
        adv_kappa, _ = get_kappa_adv(adv, ori, ori_normal, cfg.curv_loss_knn)
        return (chamfer_loss(adv, ori)
                + HD_LOSS_WEIGHT * hausdorff_loss(adv, ori)
                + curvature_loss(adv, ori, adv_kappa, ori_kappa))

    def success_of(pred, labels):
        return (pred == labels) if cfg.targeted else (pred != labels)

    def attack(points, labels, generator: Optional[torch.Generator] = None
               ) -> AttackResult:
        draws.check(generator)
        points = torch.as_tensor(points, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels).to(dev).long()
        ori = points[..., :3].contiguous()
        normal = points[..., 3:6].contiguous()
        B = ori.shape[0]
        with torch.no_grad():
            ori_kappa = get_kappa(ori, normal, cfg.curv_loss_knn)

        lower = torch.zeros(B, device=dev)
        upper = torch.full((B,), MAX_CONST, device=dev)
        weight = torch.full((B,), INITIAL_CONST, device=dev)
        o_best = BestState.init(ori)
        adv = torch.zeros_like(ori)
        for step in range(cfg.binary_max_steps):
            adv = ori + draws.noise(ori.shape, generator, step)
            opt = adam_init(adv)
            best = BestState.init(ori)
            for _ in range(cfg.iter_max_steps):
                with torch.enable_grad():
                    x = adv.detach().requires_grad_(True)
                    logits = logits_fn(x)
                    dist = dist_terms(x, ori, normal, ori_kappa)
                    loss = batch_mean(adv_fn(logits, labels) + weight * dist)
                    (grad,) = torch.autograd.grad(loss, x)
                with torch.no_grad():
                    pred = torch.argmax(logits, dim=-1)
                    ok = success_of(pred, labels)
                    dist = dist.detach()
                    best = update_best(best, ok, dist, pred, adv)
                    o_best = update_best(o_best, ok, dist, pred, adv)
                    adv, opt = adam_update(grad, opt, adv, cfg.attack_lr)
            found = (success_of(best.score, labels) & (best.score != -1)
                     & (best.dist <= o_best.dist))
            lower, upper, weight = binary_search_update(found, lower, upper,
                                                        weight)

        # failures fall back to the last iterate
        success = lower > 0.0
        adv_final = torch.where(success[:, None, None], o_best.adv, adv)
        with torch.no_grad():
            pred = torch.argmax(logits_fn(adv_final), dim=-1)
        return AttackResult(adv_points=adv_final, success=success,
                            pred=pred)

    return attack
