"""Attack-evaluation driver: ``python -m hitadv_torch.eval``.

Port of `hitadv_tpu/eval.py` (reference `eval.py:21-135`): build the
victim, the batches and the attack, then run `evaluation.eval_asr` and
print its metrics. It runs on the card unless ``--device cpu`` is given,
and raises when asked for CUDA without one.

The port has the attacks HiT-ADV, CW-Perturb (targeted and untargeted,
L2 or ``--dist_func chamfer``), CW-kNN and CW-UKNN, and the synthetic
dataset. The other registry names, the real datasets, the defenses,
restarts and the device meshes raise `NotImplementedError` naming the
`ROADMAP.md` item that brings them; nothing falls back to something else.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
from typing import Callable, Tuple

import torch

from hitadv_torch import resolve_device
from hitadv_torch.config import EvalConfig, add_config_flags, config_from_args


def _not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a setting that `ROADMAP.md` §1's item titled ``item``
    brings (named by title: a renumbering of the items leaves it true)."""
    return NotImplementedError(
        f"hitadv_torch.eval: {what} is not ported yet (ROADMAP.md §1, "
        f"{item})")


# attack names -> the title of the ROADMAP.md §1 item that ports them
_ATTACK_ITEMS = {
    **dict.fromkeys(("fgsm", "ifgsm", "mifgsm", "pgd", "fgsm-rs", "fgm-l2",
                     "ifgm-l2", "drop"), "FGM family and SaliencyDrop"),
    **dict.fromkeys(("geoa3", "geoa3-untarget"), "GeoA3"),
    **dict.fromkeys(("add", "add-cluster", "add-object"), "Add attacks"),
    **dict.fromkeys(("cw-lpips", "aof", "taof", "uaeaof", "advpc",
                     "uadvpc"), "Autoencoder attacks and CW-LPIPS")}


def check_ported(cfg: EvalConfig) -> None:
    """Raise `NotImplementedError` for every setting besides the attack
    that the port does not run yet (`build_attack` checks the attack)."""
    if cfg.model == "geoa3_pointnet":
        raise _not_ported("--model geoa3_pointnet", "GeoA3")
    if cfg.dataset in ("ModelNet", "ShapeNetPart"):
        raise _not_ported(f"--dataset {cfg.dataset}", "Data loaders")
    if cfg.defense_method or cfg.eval_defense_method:
        raise _not_ported("--defense_method / --eval_defense_method",
                          "Defenses")
    for flag, value in (("--restarts", cfg.restarts),
                        ("--n_devices", cfg.n_devices),
                        ("--sp_devices", cfg.sp_devices)):
        if value and value > 1:
            raise _not_ported(flag, "Parallelism")


def build_model(cfg: EvalConfig) -> torch.nn.Module:
    """The victim on ``cfg.device`` (reference `eval.py:105-124`): a fresh
    initialisation from ``cfg.seed``, or ``--checkpoint``, a pickled
    parameter tree (``.pkl``) or the reference's torch checkpoint; bf16
    activations with ``--bf16``."""
    from hitadv_torch import models
    from hitadv_torch.convert import params_from_numpy
    from hitadv_torch.utils import checkpoint as ckpt

    dev = resolve_device(cfg.device)
    kw = dict(compute_dtype=torch.bfloat16 if cfg.bf16 else None, device=dev)
    if cfg.model == "dgcnn":
        kw["cfg"] = models.DGCNNConfig(k=cfg.k, emb_dims=cfg.emb_dims)
    cls = models.get_model(cfg.model)
    if not cfg.checkpoint:
        return cls(cfg.num_class, generator=torch.Generator(
            device=dev).manual_seed(cfg.seed), **kw)
    if cfg.checkpoint.endswith((".pkl", ".pickle")):
        tree = ckpt.load_params(cfg.checkpoint)
    else:
        module = {"pointnet": models.pointnet, "pointnet++": models.pointnet2,
                  "dgcnn": models.dgcnn, "pct": models.pct,
                  "pointconv": models.pointconv}[cfg.model]
        tree = ckpt.convert_state_dict(
            ckpt.load_torch_state_dict(cfg.checkpoint), module.TORCH_SPEC)
    return cls(params=params_from_numpy(tree, dev), **kw)


def _cw_dist_fn(cfg: EvalConfig):
    """CW-Perturb's distance: the reference's L2 (None) by default, the
    Chamfer distance with ``--dist_func chamfer``."""
    from hitadv_torch import losses

    if cfg.dist_func in (None, "l2"):
        return None
    if cfg.dist_func != "chamfer":
        raise ValueError(f"dist_func {cfg.dist_func!r}")
    return losses.chamfer_dist


def build_attack(cfg: EvalConfig, logits_fn: Callable) -> Callable:
    """The attack ``cfg.attack_type`` on ``cfg.device`` (the reference's
    registry, `eval.py:51-225`, for the attacks the port has): ``attack(
    points [B, N, 3|6], labels, generator) -> AttackResult``."""
    from hitadv_torch import attacks, losses

    dev = resolve_device(cfg.device)
    name = cfg.attack_type.lower().replace("_", "-")
    untargeted_margin = attacks.make_adv_fn("logits", cfg.kappa,
                                            targeted=False)
    targeted_margin = attacks.make_adv_fn("logits", cfg.kappa, targeted=True)
    cw_cfg = attacks.CWConfig(
        attack_lr=cfg.attack_lr, init_weight=cfg.init_weight,
        max_weight=cfg.max_weight, binary_step=cfg.binary_step,
        num_iter=cfg.num_iter)

    if name == "hit-adv":
        hit_cfg = attacks.HiTADVConfig(
            attack_lr=cfg.attack_lr, binary_step=cfg.binary_step,
            num_iter=cfg.num_iter, cd_weight=cfg.cd_weight,
            ker_weight=cfg.ker_weight, hide_weight=cfg.hide_weight,
            curv_loss_knn=cfg.curv_loss_knn, central_num=cfg.central_num,
            total_central_num=cfg.total_central_num,
            max_sigm=cfg.max_sigm, min_sigm=cfg.min_sigm,
            budget=cfg.budget)
        return attacks.make_hit_adv(logits_fn, untargeted_margin, hit_cfg,
                                    device=dev)
    if name in ("cw-perturb", "cw-perturbt"):
        return attacks.make_cw_perturb(
            logits_fn, targeted_margin, _cw_dist_fn(cfg),
            dataclasses.replace(cw_cfg, targeted=True), device=dev)
    if name == "cw-uperturb":
        return attacks.make_cw_perturb(
            logits_fn, untargeted_margin, _cw_dist_fn(cfg),
            dataclasses.replace(cw_cfg, targeted=False), device=dev)
    if name in ("cw-knn", "cw-uknn"):
        targeted = name == "cw-knn"

        def clip_fn(adv_pc, ori, normal):
            return losses.project_inner_clip_linf(adv_pc, ori, cfg.budget,
                                                  normal)

        return attacks.make_cw_knn(
            logits_fn, targeted_margin if targeted else untargeted_margin,
            losses.chamfer_knn_dist, clip_fn,
            attacks.CWKNNConfig(targeted=targeted), device=dev)
    if name in _ATTACK_ITEMS:
        raise _not_ported(f"the attack {cfg.attack_type!r}",
                          _ATTACK_ITEMS[name])
    raise ValueError(f"unknown attack_type {cfg.attack_type!r}")


def build_batches(cfg: EvalConfig):
    """The synthetic batches (``--dataset synthetic``), the only dataset
    the port has."""
    from hitadv_torch.data import synthetic_batches

    if cfg.dataset != "synthetic":
        raise ValueError(f"dataset {cfg.dataset!r}")
    return synthetic_batches(max(1, cfg.synthetic_size // cfg.batch_size),
                             cfg.batch_size, cfg.num_point, cfg.num_class,
                             seed=cfg.seed)


def parse_args(argv=None) -> Tuple[EvalConfig, argparse.Namespace]:
    """The command line's `EvalConfig` and its parsed arguments (the
    config's flags and ``--resume``)."""
    parser = argparse.ArgumentParser("hitadv_torch eval")
    add_config_flags(parser)
    parser.add_argument("--resume", default=None,
                        help="progress file for resumable sweeps")
    args = parser.parse_args(argv)
    return config_from_args(args), args


def main(argv=None) -> dict:
    from hitadv_torch.evaluation import eval_asr
    from hitadv_torch.utils import EvalProgress

    cfg, args = parse_args(argv)
    check_ported(cfg)
    dev = resolve_device(cfg.device)

    model = build_model(cfg)
    attack = build_attack(cfg, model)
    batches = build_batches(cfg)
    if cfg.max_batches:
        batches = itertools.islice(batches, cfg.max_batches)
    progress = EvalProgress(args.resume) if args.resume else None
    metrics = eval_asr(model, attack, batches, seed=cfg.seed,
                       uniform_k=cfg.k, log_dir=cfg.log_dir,
                       progress=progress, device=dev)
    print({k: round(float(v), 6) for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main()
