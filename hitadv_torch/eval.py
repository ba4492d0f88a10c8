"""Attack-evaluation driver: ``python -m hitadv_torch.eval``.

Port of `hitadv_tpu/eval.py` (reference `eval.py:21-135`): build the
victim, the batches and the attack, then run `evaluation.eval_asr` and
print its metrics. It runs on the card unless ``--device cpu`` is given,
and raises when asked for CUDA without one.

The port has every attack of the registry: HiT-ADV, CW-Perturb
(targeted and untargeted, L2 or ``--dist_func chamfer``), CW-LPIPS,
CW-kNN and CW-UKNN, the FGM family (FGSM, IFGSM, MIFGSM, PGD, FGSM-RS,
FGM-L2, IFGM-L2), SaliencyDrop, GeoA3 and GeoA3-Untarget, the Add
attacks (Add, Add-Cluster, Add-Object), AOF, TAOF and UAEAOF, AdvPC and
UAdvPC (the autoencoder: ``--ae_checkpoint``, else fitted on the eval's
clouds and cached under ``HITADV_CACHE_DIR``, else with
``--ae_fit_steps 0`` a random one); the victims PointNet, DGCNN,
PointNet++, PCT, PointConv and GeoA3's PointNet; the defenses SRS, SOR
and jitter, at attack time (``--defense_method``: the attack
differentiates through it, and the judging sees it too) and at eval time
(``--eval_defense_method``: the judging alone); and the synthetic
dataset. The real datasets, restarts and the device meshes raise
`NotImplementedError` naming the `ROADMAP.md` item that brings them;
nothing falls back to something else.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from hitadv_torch import resolve_device
from hitadv_torch.config import EvalConfig, add_config_flags, config_from_args


def _not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a setting that `ROADMAP.md` §1's item titled ``item``
    brings (named by title: a renumbering of the items leaves it true)."""
    return NotImplementedError(
        f"hitadv_torch.eval: {what} is not ported yet (ROADMAP.md §1, "
        f"{item})")


# the FGM family's registry names -> their makers in `attacks`
_FGM_MAKERS = {"fgsm": "make_fgsm", "ifgsm": "make_ifgsm",
               "mifgsm": "make_mifgsm", "pgd": "make_pgd",
               "fgsm-rs": "make_fgsm_rs", "fgm-l2": "make_fgm_l2",
               "ifgm-l2": "make_ifgm_l2"}


def check_ported(cfg: EvalConfig) -> None:
    """Raise `NotImplementedError` for every setting that the port does
    not run yet (every attack of the registry runs)."""
    if cfg.dataset in ("ModelNet", "ShapeNetPart"):
        raise _not_ported(f"--dataset {cfg.dataset}", "Data loaders")
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
                  "pointconv": models.pointconv,
                  "geoa3_pointnet": models.geoa3_pointnet}[cfg.model]
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


def build_attack(cfg: EvalConfig, logits_fn: Callable,
                 model: Optional[torch.nn.Module] = None,
                 ae_fn: Optional[Callable] = None) -> Callable:
    """The attack ``cfg.attack_type`` on ``cfg.device`` (the reference's
    registry, `eval.py:51-225`): ``attack(points [B, N, 3|6], labels,
    generator) -> AttackResult``. The FGM family differentiates
    ``--adv_func`` (untargeted); the targeted attacks (CW-Perturb,
    CW-LPIPS, the Add family, TAOF, AdvPC, GeoA3) pull towards the labels
    they are handed. Every attack reads the coordinates ``points[...,
    :3]`` itself, and GeoA3 the normals ``points[..., 3:6]`` too.

    ``model`` is the undefended victim, whose features CW-LPIPS compares
    (PointNet only); ``ae_fn`` the autoencoder of UAEAOF, AdvPC and
    UAdvPC (`default_ae` when None)."""
    from hitadv_torch import attacks, losses

    dev = resolve_device(cfg.device)
    name = cfg.attack_type.lower().replace("_", "-")
    untargeted_margin = attacks.make_adv_fn("logits", cfg.kappa,
                                            targeted=False)
    targeted_margin = attacks.make_adv_fn("logits", cfg.kappa, targeted=True)
    ce = attacks.make_adv_fn(cfg.adv_func, cfg.kappa, targeted=False)
    fgm_cfg = attacks.FGMConfig(budget=cfg.budget, num_iter=cfg.num_iter,
                                step_size=cfg.step_size, mu=cfg.mu)
    cw_cfg = attacks.CWConfig(
        attack_lr=cfg.attack_lr, init_weight=cfg.init_weight,
        max_weight=cfg.max_weight, binary_step=cfg.binary_step,
        num_iter=cfg.num_iter)

    def linf_clip(adv, ori):
        return losses.clip_points_linf(adv, ori, cfg.budget)

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
    if name in _FGM_MAKERS:
        return getattr(attacks, _FGM_MAKERS[name])(logits_fn, ce, fgm_cfg,
                                                   device=dev)
    if name in ("cw-perturb", "cw-perturbt"):
        return attacks.make_cw_perturb(
            logits_fn, targeted_margin, _cw_dist_fn(cfg),
            dataclasses.replace(cw_cfg, targeted=True), device=dev)
    if name == "cw-uperturb":
        return attacks.make_cw_perturb(
            logits_fn, untargeted_margin, _cw_dist_fn(cfg),
            dataclasses.replace(cw_cfg, targeted=False), device=dev)
    if name == "cw-lpips":
        # CW-Perturb with the LPIPS distance over the PointNet feature
        # stack (`util/dist_utils.py:412-461` and the feature model)
        if cfg.model != "pointnet" or model is None:
            raise ValueError("CW-LPIPS needs the pointnet feature model "
                             "(pass model to build_attack)")

        def lpips_fn(adv, ori):
            return losses.lpips_distance(model.features(adv),
                                         model.features(ori))

        return attacks.make_cw_perturb(
            logits_fn, targeted_margin, lpips_fn,
            dataclasses.replace(cw_cfg, targeted=True), device=dev)
    if name in ("cw-knn", "cw-uknn"):
        targeted = name == "cw-knn"

        def clip_fn(adv_pc, ori, normal):
            return losses.project_inner_clip_linf(adv_pc, ori, cfg.budget,
                                                  normal)

        return attacks.make_cw_knn(
            logits_fn, targeted_margin if targeted else untargeted_margin,
            losses.chamfer_knn_dist, clip_fn,
            attacks.CWKNNConfig(targeted=targeted), device=dev)
    if name in ("aof", "taof", "uaeaof"):
        mode = {"aof": "untargeted", "taof": "targeted",
                "uaeaof": "ae_untargeted"}[name]
        if mode == "ae_untargeted" and ae_fn is None:
            ae_fn = default_ae(cfg)
        # UAEAOF's GAMMA is 0.25 (`CW/UAEAOF.py:59`), AOF's and TAOF's
        # 0.5 (`CW/AOF.py:59`)
        return attacks.make_aof(
            logits_fn,
            targeted_margin if mode == "targeted" else untargeted_margin,
            linf_clip, attacks.AOFConfig(
                attack_lr=cfg.attack_lr, num_iter=cfg.num_iter, mode=mode,
                gamma=0.25 if mode == "ae_untargeted" else 0.5),
            ae_fn=ae_fn, device=dev)
    if name in ("advpc", "uadvpc"):
        targeted = name == "advpc"
        if ae_fn is None:
            ae_fn = default_ae(cfg)
        return attacks.make_advpc(
            logits_fn, ae_fn,
            targeted_margin if targeted else untargeted_margin, linf_clip,
            attacks.AdvPCConfig(attack_lr=cfg.attack_lr,
                                num_iter=cfg.num_iter, targeted=targeted),
            device=dev)
    if name == "add":
        # the reference's 512 added points assume N = 1024; the
        # critical-point cut needs num_add <= N
        return attacks.make_cw_add(
            logits_fn, targeted_margin, cfg=attacks.AddConfig(
                num_iter=cfg.num_iter, binary_step=cfg.binary_step,
                num_add=min(512, cfg.num_point)), device=dev)
    if name == "add-cluster":
        return attacks.make_cw_add_clusters(
            logits_fn, targeted_margin,
            cfg=attacks.AddClusterConfig(num_iter=cfg.num_iter), device=dev)
    if name == "add-object":
        return attacks.make_cw_add_objects(
            logits_fn, targeted_margin,
            cfg=attacks.AddObjectConfig(num_iter=cfg.num_iter), device=dev)
    if name in ("geoa3", "geoa3-untarget"):
        return attacks.make_geoa3(
            logits_fn, attacks.GeoA3Config(
                attack_lr=cfg.attack_lr, binary_max_steps=cfg.binary_step,
                iter_max_steps=cfg.num_iter,
                curv_loss_knn=cfg.curv_loss_knn,
                targeted=(name == "geoa3")), device=dev)
    if name == "drop":
        return attacks.make_saliency_drop(
            logits_fn, attacks.DropConfig(
                num_drop=min(cfg.num_drop, cfg.num_point // 2), k=cfg.k),
            device=dev)
    raise ValueError(f"unknown attack_type {cfg.attack_type!r}")


def ae_cache_path(cfg: EvalConfig) -> str:
    """Where `default_ae` caches a fitted AE: ``HITADV_CACHE_DIR``, else
    ``~/.cache/hitadv_torch``. An f32 fit takes the JAX package's file
    name (dataset, points, steps and seed), so that either package's f32
    fit loads; a ``--bf16`` fit adds ``_bf16`` to it, so that an f32 run
    never loads a bf16 fit nor the other way round. (The JAX package
    names its bf16 fits as its f32 ones: in a cache directory shared
    with it, the port's f32 run loads whichever it wrote.)"""
    cache_dir = os.environ.get(
        "HITADV_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "hitadv_torch"))
    dtype = "_bf16" if cfg.bf16 else ""
    return os.path.join(cache_dir, f"ae_{cfg.dataset}_{cfg.num_point}p_"
                                   f"{cfg.ae_fit_steps}s_{cfg.seed}"
                                   f"{dtype}.pkl")


def default_ae(cfg: EvalConfig) -> torch.nn.Module:
    """The autoencoder of UAEAOF, AdvPC and UAdvPC (reference
    `CW/AdvPC.py:83-99,142`; JAX `eval._default_ae`), on ``cfg.device``,
    bf16 with ``--bf16`` as the victim:
      1. ``--ae_checkpoint``, a pickled parameter tree (either package's
         ``save_params``);
      2. else, with ``--ae_fit_steps`` > 0, the tree cached at
         `ae_cache_path`, or one fitted there and then for that many Adam
         steps on the first 8 batches' clouds (Chamfer reconstruction,
         batches of up to 16, from the initialisation of seed ``--seed``,
         the batch draws of seed ``--seed`` + 1) and cached;
      3. ``--ae_fit_steps 0``: a random AE, with the reference's warning.
    A missing checkpoint or a failed fit raises."""
    from hitadv_torch.convert import params_from_numpy
    from hitadv_torch.models import autoencoder as AE
    from hitadv_torch.utils import checkpoint as ckpt

    dev = resolve_device(cfg.device)
    kw = dict(compute_dtype=torch.bfloat16 if cfg.bf16 else None, device=dev)

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def loaded(path):
        return AE.AutoEncoder(
            params=params_from_numpy(ckpt.load_params(path), dev), **kw)

    if cfg.ae_checkpoint:
        return loaded(cfg.ae_checkpoint)
    if cfg.ae_fit_steps <= 0:
        print("WARNING: running an AE-conditioned attack with a RANDOM "
              "autoencoder (--ae_fit_steps 0). The reference assumes a "
              "pretrained AE (CW/AdvPC.py:83-99); success senses and "
              "ASR are NOT comparable. Pass --ae_checkpoint or set "
              "--ae_fit_steps > 0.")
        return AE.AutoEncoder(cfg.num_point, generator=seeded(cfg.seed),
                              **kw)
    cache = ae_cache_path(cfg)
    if os.path.exists(cache):
        print(f"loading cached fitted AE: {cache}")
        return loaded(cache)
    print(f"no --ae_checkpoint given: fitting the AE on eval data "
          f"({cfg.ae_fit_steps} steps) and caching to {cache}")
    clouds = torch.from_numpy(np.concatenate(
        [pts[..., :3] for pts, _ in itertools.islice(build_batches(cfg), 8)],
        axis=0).astype(np.float32)).to(dev)
    tree = AE.fit(AE.init_params(cfg.num_point, generator=seeded(cfg.seed),
                                 device=dev),
                  clouds, seeded(cfg.seed + 1), steps=cfg.ae_fit_steps,
                  batch_size=min(16, clouds.shape[0]),
                  compute_dtype=kw["compute_dtype"])
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    ckpt.save_params(cache, tree)
    return AE.AutoEncoder(params=tree, **kw)


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


def defended(cfg: EvalConfig, model: Callable, dev: torch.device
             ) -> Tuple[Callable, Callable]:
    """(the function the attack differentiates, the function that judges
    the clean and adversarial predictions) (reference hooks,
    `hitadv_tpu/eval.py:344-362`): ``--defense_method`` wraps the victim
    for both, its draws from a generator seeded with ``cfg.seed``;
    ``--eval_defense_method`` wraps the judging alone, on top, seeded
    with ``cfg.seed + 1``."""
    from hitadv_torch.defense import defended_logits_fn, get_defense

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    attacked = defended_logits_fn(
        model, get_defense(cfg.defense_method, seeded(cfg.seed)))
    judged = defended_logits_fn(
        attacked, get_defense(cfg.eval_defense_method, seeded(cfg.seed + 1)))
    return attacked, judged


def main(argv=None) -> dict:
    from hitadv_torch.evaluation import eval_asr
    from hitadv_torch.utils import EvalProgress

    cfg, args = parse_args(argv)
    check_ported(cfg)
    dev = resolve_device(cfg.device)

    model = build_model(cfg)
    logits_fn, eval_logits_fn = defended(cfg, model, dev)
    attack = build_attack(cfg, logits_fn, model)
    batches = build_batches(cfg)
    if cfg.max_batches:
        batches = itertools.islice(batches, cfg.max_batches)
    progress = EvalProgress(args.resume) if args.resume else None
    metrics = eval_asr(eval_logits_fn, attack, batches, seed=cfg.seed,
                       uniform_k=cfg.k, log_dir=cfg.log_dir,
                       progress=progress, device=dev)
    print({k: round(float(v), 6) for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main()
