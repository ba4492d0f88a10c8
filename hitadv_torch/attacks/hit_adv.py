"""HiT-ADV, the flagship shape-aware attack (CVPR'24 "Hide in Thicket").

Port of `hitadv_tpu/attacks/hit_adv.py`, which documents the parity
surface against the reference (`ShapeAttack/HiT_ADV.py:15-287`):
  1. score = 0.001 norm(saliency) + norm(kappa_std), whole-tensor min/max;
  2. central points: FPS(total_central_num) -> kNN ring -> per-ring
     argmax of the score -> global top central_num;
  3. deformation: a Gaussian-kernel blend of per-centre translations
     ``pert [B, Cn, 3]`` with widths ``delta [B, Cn]``, from the distance
     field built once per attack (``blend="field"``: plain exp + einsum;
     ``blend="kernel"``: the kernel pair on the transposed field, the
     reference's ``set_blend_impl("pallas")``);
  4. loss: CW margin + cd * the 3x3 "chamfer" quirk + ker * (|pert| +
     |1 - delta|) / Cn + hide * cos-sim(delta, curvature std);
  5. a binary search over the loss weight, which enters the gradient as
     its batch mean.

The reference's scans are Python loops here. Inside them nothing waits
for the device: no ``.item()``, no ``.cpu()``, no branch on a tensor; the
best-so-far bookkeeping is ``torch.where`` on device tensors. With spans
on (`utils.profiling`) an attack records ``attack.prepare``, each
``attack.binary_step`` around its ``attack.iteration`` spans, and
``attack.finalize``, and counts ``attack.iterations`` and
``attack.binary_steps``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, NamedTuple, Optional

import torch

from hitadv_torch import resolve_device
from hitadv_torch.attacks.base import (
    AdamState,
    AttackResult,
    BestState,
    adam_init,
    adam_update,
    binary_search_update,
    update_best,
)
from hitadv_torch.losses import cross_entropy_loss, get_kappa, get_kappa_std
from hitadv_torch.ops import geometry as G
from hitadv_torch.parallel.shard import (
    batch_amax,
    batch_amin,
    batch_draw,
    batch_mean,
    batch_sum,
)
from hitadv_torch.utils import profiling as P


@dataclass(frozen=True)
class HiTADVConfig:
    """Defaults of record: `eval.py:32,49-59,67` + `FGM/CWPert_args.py:39-44`."""
    attack_lr: float = 1e-2
    init_weight: float = 10.0
    max_weight: float = 80.0
    binary_step: int = 10
    num_iter: int = 100
    cd_weight: float = 1e-4
    ker_weight: float = 1.0
    hide_weight: float = 1.0
    curv_loss_knn: int = 16
    central_num: int = 192
    total_central_num: int = 256
    max_sigm: float = 1.2
    min_sigm: float = 0.1
    budget: float = 0.55
    alpha: float = 1.0


def _global_minmax_norm(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Whole-tensor (not per-example) min/max normalisation: over the
    whole batch, also when it is sharded."""
    lo, hi = batch_amin(x), batch_amax(x)
    return (x - lo) / (hi - lo + eps)


def _transformation_loss(pert, delta, Cn):
    """(|pert|_F + |1 - delta|_2) / Cn per example."""
    t = torch.sqrt(torch.sum(pert ** 2, dim=(1, 2)) + 1e-12)
    t = t + torch.sqrt(torch.sum((1.0 - delta) ** 2, dim=1) + 1e-12)
    return t / Cn


def _curv_std_loss(delta, central_kappa_std, cfg):
    """cos-sim of the range-normalised delta and the globally
    normalised central curvature std (denominator clamped at 1e-8)."""
    norm_std = _global_minmax_norm(central_kappa_std[..., 0])   # [B, Cn]
    norm_delta = (delta - cfg.min_sigm) / (cfg.max_sigm - cfg.min_sigm
                                           + 1e-7)
    num = torch.sum(norm_std * norm_delta, dim=1)
    den = (torch.linalg.vector_norm(norm_std, dim=1)
           * torch.linalg.vector_norm(norm_delta, dim=1))
    return num / torch.clamp_min(den, 1e-8)


def prepare_centrals(logits_fn: Callable, cfg: HiTADVConfig,
                     points: torch.Tensor, labels: torch.Tensor,
                     generator: Optional[torch.Generator] = None):
    """Scoring and central-point selection (reference :61-93).

    Returns ``(ori [B, N, 3], central_points [B, Cn, 3],
    central_kappa_std [B, Cn, 1])``. FPS starts at a random index drawn
    from ``generator``, or at index 0 when it is None.
    """
    ori = points[..., :3].contiguous()
    normal = points[..., 3:6]
    k = cfg.curv_loss_knn

    with torch.enable_grad():
        x = ori.detach().requires_grad_(True)
        loss = batch_mean(cross_entropy_loss(logits_fn(x), labels))
        (grad,) = torch.autograd.grad(loss, x)

    with torch.no_grad():
        ori_kappa_std = get_kappa_std(ori, normal, k=k)        # [B, N]
        center = G.median_points(ori, dim=1)                   # [B, 3]
        offset = ori - center[:, None, :]
        r = torch.sqrt(torch.sum(offset ** 2, dim=-1))         # [B, N]
        saliency = -(r ** cfg.alpha) * torch.sum(offset * grad, dim=-1)
        score = (0.001 * _global_minmax_norm(saliency)
                 + _global_minmax_norm(ori_kappa_std))         # [B, N]

        start = 0
        if generator is not None:
            B, N = ori.shape[:2]
            start = batch_draw(lambda s: torch.randint(
                0, N, s, generator=generator, device=ori.device,
                dtype=torch.int32), (B,))
        far_idx = G.farthest_point_sample(ori, cfg.total_central_num,
                                          start=start)
        far_points = G.index_points(ori, far_idx)              # [B, Tc, 3]
        far_knn = G.knn_points(far_points, ori, k + 1)         # [B, Tc, k+1]
        ring = far_knn.idx.long()
        far_knn_points = G.index_points(ori, far_knn.idx)      # [B,Tc,k+1,3]
        far_knn_score = torch.gather(
            score[:, None, :].expand(-1, ring.shape[1], -1), 2, ring)
        ring_best = torch.argmax(far_knn_score, dim=2)         # [B, Tc]
        tc_points = torch.gather(
            far_knn_points, 2,
            ring_best[..., None, None].expand(-1, -1, 1, 3))[:, :, 0, :]
        tc_score = torch.gather(far_knn_score, 2,
                                ring_best[..., None])[..., 0]  # [B, Tc]
        # lax.top_k order: descending, the lower index first among ties
        tmp_idx = torch.sort(tc_score, dim=1, descending=True,
                             stable=True).indices[:, :cfg.central_num]
        central_points = G.index_points(tc_points, tmp_idx)    # [B, Cn, 3]

        # central curvature for the hide loss (reference :118-123 gathers
        # ori_kappa, its naming notwithstanding)
        ori_kappa = get_kappa(ori, normal, k=k)                # [B, N]
        far_kappa = torch.gather(
            ori_kappa[:, None, :].expand(-1, ring.shape[1], -1), 2, ring)
        tc_kappa = torch.gather(far_kappa, 2, ring_best[..., None])
        central_kappa_std = G.index_points(tc_kappa, tmp_idx)  # [B, Cn, 1]
    return ori, central_points, central_kappa_std


BLENDS = ("field", "kernel")


def _check_blend(blend: str) -> None:
    if blend not in BLENDS:
        raise ValueError(f"blend must be one of {BLENDS}, got {blend!r}")


class InnerState(NamedTuple):
    """The inner loop's carry."""
    pert: torch.Tensor          # [B, Cn, 3]
    delta: torch.Tensor         # [B, Cn]
    opt_p: AdamState
    opt_d: AdamState
    weight: torch.Tensor        # [B] loss weight of this binary step
    best: BestState             # best of this binary step
    o_best: BestState           # best over all steps
    last: torch.Tensor          # [B, N, 3] the last deformed cloud


def make_inner_iter(logits_fn: Callable, adv_fn: Callable,
                    cfg: HiTADVConfig, ori, labels, central_points,
                    central_kappa_std, blend: str = "field"
                    ) -> Callable[[InnerState], InnerState]:
    """One Adam iteration of the attack (reference :164-245): projection,
    forward and backward of the full loss, bookkeeping, two Adam groups.
    The Gaussian field's distances are loop-invariant and built here,
    once; ``blend="kernel"`` keeps only the transposed field ``[B, N,
    Cn]`` that the kernel pair reads (reference :196-203)."""
    _check_blend(blend)
    Cn = cfg.central_num
    with torch.no_grad():
        negd = G.neg_gaussian_field(central_points, ori)       # [B, Cn, N]
        negdt = None
        if blend == "kernel":
            negdt, negd = negd.transpose(1, 2).contiguous(), None

    def deform(pert, delta):
        if negdt is not None:
            return G.gaussian_blend_negdt(negdt, delta, pert)
        return G.gaussian_blend(central_points, ori, delta, pert, negd=negd)

    def loss_fn(pert, delta, weight):
        num, deno = deform(pert, delta)
        tmp_adv = ori + num / deno[..., None]
        logits = logits_fn(tmp_adv)
        adv_loss = batch_mean(adv_fn(logits, labels))
        dist_loss = 0.0
        if cfg.cd_weight != 0:
            # reference quirk (:233-235): the "chamfer" sees channels-first
            # [B, 3, N] clouds, i.e. 3 points in N-dim space
            d33 = G.square_distance(tmp_adv.transpose(1, 2),
                                    ori.transpose(1, 2))       # [B, 3, 3]
            cd = torch.mean(torch.amin(d33, dim=2), dim=1)
            dist_loss = dist_loss + batch_mean(cd * cfg.cd_weight)
        if cfg.ker_weight != 0:
            # global Frobenius norms over the whole batch, / Cn
            t = (torch.sqrt(batch_sum(pert ** 2) + 1e-24)
                 + torch.sqrt(batch_sum((1.0 - delta) ** 2) + 1e-24))
            dist_loss = dist_loss + (t / Cn) * cfg.ker_weight
        if cfg.hide_weight != 0:
            dist_loss = dist_loss + batch_mean(
                _curv_std_loss(delta, central_kappa_std, cfg)
                * cfg.hide_weight)
        total = adv_loss + batch_mean(weight) * dist_loss
        return total, tmp_adv, logits

    def inner_iter(s: InnerState) -> InnerState:
        with torch.no_grad():
            pert = torch.clamp(s.pert, -cfg.budget, cfg.budget)
            delta = torch.clamp(s.delta, cfg.min_sigm, cfg.max_sigm)
        pert.requires_grad_(True)
        delta.requires_grad_(True)
        with torch.enable_grad():
            total, tmp_adv, logits = loss_fn(pert, delta, s.weight)
            g_pert, g_delta = torch.autograd.grad(total, (pert, delta))
        with torch.no_grad():
            pert, delta = pert.detach(), delta.detach()
            tmp_adv = tmp_adv.detach()
            pred = torch.argmax(logits, dim=-1)
            dist_val = _transformation_loss(pert, delta, Cn)
            ok = pred != labels
            best = update_best(s.best, ok, dist_val, pred, tmp_adv)
            o_best = update_best(s.o_best, ok, dist_val, pred, tmp_adv)
            pert, opt_p = adam_update(g_pert, s.opt_p, pert,
                                      cfg.attack_lr * 5.0)
            delta, opt_d = adam_update(g_delta, s.opt_d, delta,
                                       cfg.attack_lr * 3.0)
        return InnerState(pert=pert, delta=delta, opt_p=opt_p, opt_d=opt_d,
                          weight=s.weight, best=best, o_best=o_best,
                          last=tmp_adv)

    return inner_iter


def make_hit_adv(logits_fn: Callable, adv_fn: Callable,
                 cfg: HiTADVConfig = HiTADVConfig(), *,
                 init_overrides: Optional[Mapping] = None,
                 device="cuda", blend: str = "field"):
    """Build the HiT-ADV attack.

    Args:
      logits_fn: victim ``[B, N, 3] -> [B, classes]`` on ``device``.
      adv_fn: per-example adversarial loss (the eval config uses the
        untargeted CW margin with kappa=30).
      init_overrides: optional numpy/tensor arrays pinning every random
        draw, ``{"pert": [S, B, Cn, 3], "delta": [S, B, Cn]}`` indexed by
        binary step; FPS then starts at index 0. Lets a run be compared
        with the JAX package's under the same draws.
      device: where the attack runs; ``"cuda"`` unless the caller asks
        for the CPU.
      blend: ``"field"`` (exp + einsum on the hoisted field, plain
        PyTorch) or ``"kernel"`` (`geometry.gaussian_blend_negdt`, the
        kernel pair on the transposed field); any other value raises.
    Returns:
      ``attack(points [B, N, 6], labels [B], generator) ->
      AttackResult``. ``generator`` (a `torch.Generator` on ``device``)
      draws the FPS start and each binary step's initial pert/delta; it
      may be None only with ``init_overrides``.
    """
    _check_blend(blend)
    dev = resolve_device(device)
    Cn = cfg.central_num
    overrides = None
    if init_overrides is not None:
        overrides = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
                     for k, v in init_overrides.items()}

    def attack(points, labels, generator: Optional[torch.Generator] = None
               ) -> AttackResult:
        if overrides is None and generator is None:
            raise ValueError("attack: pass a torch.Generator (or build the "
                             "attack with init_overrides)")
        points = torch.as_tensor(points, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels).to(dev).long()
        B = points.shape[0]
        with P.span("attack.prepare"):
            ori, central_points, central_kappa_std = prepare_centrals(
                logits_fn, cfg, points, labels,
                generator=None if overrides is not None else generator)
            inner_iter = make_inner_iter(logits_fn, adv_fn, cfg, ori, labels,
                                         central_points, central_kappa_std,
                                         blend)

            lower = torch.zeros(B, device=dev)
            upper = torch.full((B,), cfg.max_weight, device=dev)
            weight = torch.full((B,), cfg.init_weight, device=dev)
            o_best = BestState.init(ori)
            last = torch.zeros_like(ori)
        for step in range(cfg.binary_step):
            with P.span("attack.binary_step"):
                if overrides is not None:
                    pert0 = overrides["pert"][step]
                    delta0 = overrides["delta"][step]
                else:
                    def uniform(shape):
                        return torch.rand(shape, generator=generator,
                                          device=dev)
                    pert0 = batch_draw(uniform, (B, Cn, 3)) * cfg.budget
                    delta0 = cfg.min_sigm + batch_draw(uniform, (B, Cn)) * (
                        cfg.max_sigm - cfg.min_sigm)
                s = InnerState(pert=pert0, delta=delta0,
                               opt_p=adam_init(pert0),
                               opt_d=adam_init(delta0), weight=weight,
                               best=BestState.init(ori), o_best=o_best,
                               last=last)
                for _ in range(cfg.num_iter):
                    with P.span("attack.iteration"):
                        s = inner_iter(s)
                    P.count("attack.iterations")
                best, o_best, last = s.best, s.o_best, s.last
                found = ((best.score != labels) & (best.score != -1)
                         & (best.dist <= o_best.dist))
                lower, upper, weight = binary_search_update(found, lower,
                                                            upper, weight)
            P.count("attack.binary_steps")

        with P.span("attack.finalize"):
            success = lower > 0.0
            adv_final = torch.where(success[:, None, None], o_best.adv, last)
            with torch.no_grad():
                pred = torch.argmax(logits_fn(adv_final), dim=-1)
        return AttackResult(adv_points=adv_final, success=success,
                            pred=pred)

    return attack
