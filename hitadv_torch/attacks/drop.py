"""SaliencyDrop: delete the most salient points, a few a round (port of
`hitadv_tpu/attacks/drop.py`, reference `Saliency/Drop.py:12-166`), and
the drop + FGM hybrid ``sat_forward``.

Each round scores every point by ``-r^ALPHA <p - centre, grad>`` (the CE
gradient, the coordinate-wise median as the centre, r the distance to
it) and removes the k highest. As in the JAX package the shapes stay
fixed: a removed point is collapsed onto the first survivor (for the
max-pool victims a duplicated point is the same as a deleted one), its
gradient goes back onto that survivor, and its saliency is -inf. The
survivors are compacted at the end through the row gather kernel.

The number of survivors after round i depends on i alone, so it is a
host int; the loop waits for nothing on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from hitadv_torch import resolve_device
from hitadv_torch.attacks.base import AttackResult
from hitadv_torch.losses import cross_entropy_loss
from hitadv_torch.ops import geometry as G
from hitadv_torch.parallel.shard import batch_mean


@dataclass(frozen=True)
class DropConfig:
    num_drop: int = 200
    k: int = 5                    # points dropped per round


# the saliency's radius exponent (reference `Saliency/Drop.py`)
ALPHA = 1.0


def _ce_grad(logits_fn: Callable, pc: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """The gradient of the batch-mean cross-entropy at ``pc``."""
    with torch.enable_grad():
        x = pc.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(
            batch_mean(cross_entropy_loss(logits_fn(x), labels)), x)
    return g


def _score(pc: torch.Tensor, grad: torch.Tensor,
           center: torch.Tensor) -> torch.Tensor:
    """``-r^ALPHA <pc - center, grad>`` ``[B, N]``."""
    offset = pc - center[:, None, :]
    r = torch.sqrt(torch.sum(offset ** 2, dim=-1))
    return -(r ** ALPHA) * torch.sum(offset * grad, dim=-1)


def _saliency(logits_fn: Callable, pc: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` saliency around the lower median (reference
    `Saliency/Drop.py:82-92`)."""
    grad = _ce_grad(logits_fn, pc, labels)
    return _score(pc, grad, G.median_points(pc, 1))


def _descending(x: torch.Tensor) -> torch.Tensor:
    """Indices of ``x`` by descending value, ties lowest index first (as
    ``lax.top_k``; `torch.topk` does not promise the order of ties)."""
    return torch.sort(x, dim=1, descending=True, stable=True).indices


def _collapsed(ori: torch.Tensor, alive: torch.Tensor):
    """(the first survivor's index ``[B]``, the cloud with every dead point
    moved onto it)."""
    first = torch.argmax(alive.to(torch.int8), dim=1)        # first True
    anchor = torch.gather(ori, 1, first[:, None, None].expand(-1, 1, 3))
    return first, torch.where(alive[..., None], ori, anchor)


def make_saliency_drop(logits_fn: Callable, cfg: DropConfig = DropConfig(),
                       *, device="cuda"):
    """The dropping attack: ``attack(points [B, N, >=3], labels,
    generator=None) -> AttackResult`` whose ``adv_points`` is the compact
    ``[B, N - num_drop, 3]`` cloud of survivors in their original order.
    It draws nothing; the generator is accepted for the common attack
    signature."""
    dev = resolve_device(device)
    num_rounds = -(-cfg.num_drop // cfg.k)                   # ceil

    def attack(points, labels, generator: Optional[torch.Generator] = None
               ) -> AttackResult:
        points = torch.as_tensor(points, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels).to(dev).long()
        ori = points[..., :3].contiguous()
        B, N, _ = ori.shape
        rows = torch.arange(B, device=dev)
        alive = torch.ones((B, N), dtype=torch.bool, device=dev)
        for i in range(num_rounds):
            k = min(cfg.k, cfg.num_drop - i * cfg.k)
            n_alive = N - min(i * cfg.k, cfg.num_drop)
            first, pc = _collapsed(ori, alive)
            grad = _ce_grad(logits_fn, pc, labels)
            with torch.no_grad():
                # the anchor's gradient is the total over its coincident
                # copies: the dead copies' shares go back onto it
                dead_g = torch.sum(torch.where(alive[..., None], 0.0, grad),
                                   dim=1)                    # [B, 3]
                grad = grad.index_put((rows, first), dead_g, accumulate=True)
                # the median of the shrunk cloud (`Drop.py:83-84`): the
                # (n_alive - 1) // 2-th order statistic of the survivors
                center = torch.sort(
                    torch.where(alive[..., None], ori, float("inf")),
                    dim=1).values[:, (n_alive - 1) // 2, :]  # [B, 3]
                sal = _score(pc, grad, center)
                sal = torch.where(alive, sal, float("-inf"))
                drop = _descending(sal)[:, :k]
                alive = alive.scatter(1, drop, False)
        _, pc = _collapsed(ori, alive)
        # compact: the survivors first, in index order
        order = torch.argsort((~alive).to(torch.int8), dim=1, stable=True)
        survivors = G.index_points(pc, order[:, :N - cfg.num_drop])
        with torch.no_grad():
            pred = torch.argmax(logits_fn(survivors), dim=-1)
        return AttackResult(adv_points=survivors, success=pred != labels,
                            pred=pred)

    return attack


def make_sat_forward(logits_fn: Callable, budget: float,
                     cfg: DropConfig = DropConfig(), *, device="cuda"):
    """The drop + FGM hybrid (reference `Saliency/Drop.py:115-165`):
    ``sat_forward(points, labels) -> (adv_pc [B, N, 3], del_pc [B, N -
    num_drop, 3])``, the cloud with its ``num_drop`` most salient points
    moved by an FGSM step of ``budget`` and put first, and the cloud with
    them deleted (the rest in ascending saliency)."""
    dev = resolve_device(device)

    def sat_forward(points, labels):
        points = torch.as_tensor(points, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels).to(dev).long()
        ori = points[..., :3].contiguous()
        N = ori.shape[1]
        grad = _ce_grad(logits_fn, ori, labels)
        sal = _saliency(logits_fn, ori, labels)
        with torch.no_grad():
            keep_idx = _descending(-sal)[:, :N - cfg.num_drop]
            pert_idx = _descending(sal)[:, :cfg.num_drop]
            del_pc = G.index_points(ori, keep_idx)
            adv_pert = G.index_points(ori + torch.sign(grad) * budget,
                                      pert_idx)
            return torch.cat([adv_pert, del_pc], dim=1), del_pc

    return sat_forward
