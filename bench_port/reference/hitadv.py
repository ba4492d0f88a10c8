"""HiT-ADV (Lou et al., CVPR 2024, "Hide in Thicket"), its preparation
and one Adam iteration, written from the paper and its published code
(`ShapeAttack/HiT_ADV.py`):

* preparation: each point's score is 0.001 times its normalised saliency
  (``-r * <p - median, dL/dp>`` of the clean cloud's cross-entropy) plus
  its normalised curvature std over its 16-NN ring, each normalised by
  the whole batch's minimum and maximum; FPS of ``total_central_num``
  points from a drawn start, the best-scoring point of each one's 17-NN
  ring, and the ``central_num`` of highest score among those, in
  descending order (the lower index first among equals);
* one iteration from a given state: the per-centre translations and
  widths clamped, the Gaussian-kernel blend of the translations, the CW
  margin (kappa) of the deformed cloud, the "chamfer" of the clouds read
  channels-first (3 points of N coordinates, as the code has it), the
  translations' and widths' norms over the whole batch, the cosine of
  the widths with the centres' curvature std, the loss weight's batch
  mean on those, two Adam groups (torch's Adam, learning rates 5 and 3
  times ``attack_lr``), and the best-so-far record of the iteration;
* the search for each cloud's loss weight between binary steps, and the
  answer: the best record over all steps where one succeeded, the last
  deformed cloud elsewhere.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bench_port.reference import geometry as G
from bench_port.reference.losses import (
    cross_entropy,
    loss_grad,
    untargeted_margin,
)
from bench_port.reference.metrics import kappa_std


def _minmax(x: torch.Tensor) -> torch.Tensor:
    return (x - torch.amin(x)) / (torch.amax(x) - torch.amin(x) + 1e-7)


class Centrals(NamedTuple):
    points: torch.Tensor      # [B, Cn, 3]
    kappa: torch.Tensor       # [B, Cn] the curvature at each centre


def prepare(forward, params, config, ori, normal, labels, start, cfg,
            block: int) -> Centrals:
    """The central points of the clouds ``ori`` for an FPS from
    ``start`` ``[B]``."""
    k = cfg["curv_loss_knn"]
    _, grad = loss_grad(forward, params, config, ori, labels, cross_entropy,
                        block)
    kstd, kappa = kappa_std(ori, normal, k)
    N = ori.shape[1]
    centre = torch.sort(ori, dim=1).values[:, (N - 1) // 2]
    offset = ori - centre[:, None, :]
    r = torch.sqrt(torch.sum(offset ** 2, dim=-1))
    saliency = -r * torch.sum(offset * grad, dim=-1)
    score = 0.001 * _minmax(saliency) + _minmax(kstd)
    far = G.fps(ori, cfg["total_central_num"], start)
    _, ring = G.knn(G.gather(ori, far), ori, k + 1)          # [B, Tc, k+1]
    ring_score = torch.gather(score, 1, ring.reshape(ring.shape[0], -1)
                              ).reshape(ring.shape)
    pick = torch.gather(ring, 2, torch.argmax(ring_score, 2, keepdim=True)
                        )[..., 0]                            # [B, Tc]
    pick_score = torch.gather(score, 1, pick)
    order = torch.sort(pick_score, dim=1, descending=True, stable=True
                       ).indices[:, :cfg["central_num"]]
    chosen = torch.gather(pick, 1, order)
    return Centrals(points=G.gather(ori, chosen),
                    kappa=torch.gather(kappa, 1, chosen))


class Adam(NamedTuple):
    step: int
    mu: torch.Tensor
    nu: torch.Tensor


def adam(grad, state: Adam, param, lr: float):
    t = state.step + 1
    mu = 0.9 * state.mu + 0.1 * grad
    nu = 0.999 * state.nu + 0.001 * grad * grad
    b1 = float(torch.tensor(1.0) - torch.tensor(0.9) ** t)
    b2 = float(torch.tensor(1.0) - torch.tensor(0.999) ** t)
    return param - lr * (mu / b1) / (torch.sqrt(nu / b2) + 1e-8), \
        Adam(t, mu, nu)


class Best(NamedTuple):
    dist: torch.Tensor
    score: torch.Tensor
    adv: torch.Tensor


def _best(best: Best, ok, dist, pred, adv) -> Best:
    better = ok & (dist < best.dist)
    return Best(torch.where(better, dist, best.dist),
                torch.where(better, pred.to(best.score.dtype), best.score),
                torch.where(better[:, None, None], adv, best.adv))


def search(found, lower, upper, weight):
    """One step of each cloud's search for its loss weight (the binary
    search of the published code): a cloud whose binary step found a
    success no larger than its best so far raises its lower end to the
    weight, any other lowers its upper end to it; the next weight is the
    middle of the two ends."""
    lower = torch.where(found, torch.maximum(lower, weight), lower)
    upper = torch.where(found, upper, torch.minimum(upper, weight))
    return lower, upper, 0.5 * (lower + upper)


class Step(NamedTuple):
    pert: torch.Tensor
    delta: torch.Tensor
    deformed: torch.Tensor
    logits: torch.Tensor
    best: Best
    o_best: Best


def iterate(forward, params, config, ori, labels, centrals: Centrals,
            pert, delta, opt_p: Adam, opt_d: Adam, weight, best: Best,
            o_best: Best, cfg, block: int) -> Step:
    """One Adam iteration from the state ``(pert, delta, opt_p, opt_d,
    weight, best, o_best)``."""
    Cn = cfg["central_num"]
    pert = torch.clamp(pert, -cfg["budget"], cfg["budget"]
                       ).requires_grad_(True)
    delta = torch.clamp(delta, cfg["min_sigm"], cfg["max_sigm"]
                        ).requires_grad_(True)
    diff = ori[:, None, :, :] - centrals.points[:, :, None, :]
    negd = -torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-24)  # [B, Cn, N]
    with torch.enable_grad():
        ker = torch.exp(negd / (2.0 * delta * delta)[..., None])
        num = torch.einsum("bjc,bjn->bnc", pert, ker)
        deno = torch.sum(ker, dim=1)
        deformed = ori + num / deno[..., None]
    logits, g_adv = loss_grad(
        forward, params, config, deformed.detach(), labels,
        lambda lg, y: untargeted_margin(lg, y, cfg["kappa"]), block)
    with torch.enable_grad():
        d33 = G.sqdist_mm(deformed.transpose(1, 2), ori.transpose(1, 2))
        cd = torch.mean(torch.amin(d33, dim=2), dim=1)
        dist = torch.mean(cd * cfg["cd_weight"])
        norms = (torch.sqrt(torch.sum(pert ** 2) + 1e-24)
                 + torch.sqrt(torch.sum((1.0 - delta) ** 2) + 1e-24))
        dist = dist + norms / Cn * cfg["ker_weight"]
        s = _minmax(centrals.kappa)
        d = (delta - cfg["min_sigm"]) / (cfg["max_sigm"] - cfg["min_sigm"]
                                         + 1e-7)
        cos = torch.sum(s * d, 1) / torch.clamp_min(
            torch.linalg.vector_norm(s, dim=1)
            * torch.linalg.vector_norm(d, dim=1), 1e-8)
        dist = dist + torch.mean(cos * cfg["hide_weight"])
        g_pert, g_delta = torch.autograd.grad(
            [deformed, torch.mean(weight) * dist], [pert, delta],
            grad_outputs=[g_adv, torch.ones(())])
    pert, delta, deformed = pert.detach(), delta.detach(), deformed.detach()
    pred = torch.argmax(logits, dim=-1)
    size = (torch.sqrt(torch.sum(pert ** 2, dim=(1, 2)) + 1e-12)
            + torch.sqrt(torch.sum((1.0 - delta) ** 2, dim=1) + 1e-12)) / Cn
    ok = pred != labels
    lr = cfg["attack_lr"]
    new_pert, _ = adam(g_pert, opt_p, pert, lr * 5.0)
    new_delta, _ = adam(g_delta, opt_d, delta, lr * 3.0)
    return Step(pert=new_pert, delta=new_delta, deformed=deformed,
                logits=logits, best=_best(best, ok, size, pred, deformed),
                o_best=_best(o_best, ok, size, pred, deformed))
