"""Attack-evaluation driver: ``python -m hitadv_torch.eval``.

Port of `hitadv_tpu/eval.py` (reference `eval.py:21-135`): build the
victim, the batches and the attack, then run `evaluation.eval_asr` and
print its metrics. It runs on the card unless ``--device cpu`` is given,
and raises when asked for CUDA without one. Every flag of the JAX `eval`
runs:

  * the datasets: ``--dataset ModelNet`` (``modelnet40_normal_resampled``
    txt files, `data.ModelNetDataset`) and ``ShapeNetPart``
    (`data.PartNormalDataset`) from ``--data_path``, read by
    ``--num_workers`` loader threads, and ``synthetic``. Without
    ``--data_path`` a real dataset raises (the JAX `eval` runs
    synthetic clouds instead);
  * every attack of the registry: HiT-ADV, CW-Perturb (targeted and
    untargeted, L2 or ``--dist_func chamfer``), CW-LPIPS, CW-kNN and
    CW-UKNN, the FGM family (FGSM, IFGSM, MIFGSM, PGD, FGSM-RS, FGM-L2,
    IFGM-L2), SaliencyDrop, GeoA3 and GeoA3-Untarget, the Add attacks
    (Add, Add-Cluster, Add-Object), AOF, TAOF and UAEAOF, AdvPC and
    UAdvPC (the autoencoder: ``--ae_checkpoint``, else fitted on the
    eval's clouds and cached under ``HITADV_CACHE_DIR``, else with
    ``--ae_fit_steps 0`` a random one), against the victims PointNet,
    DGCNN, PointNet++, PCT, PointConv and GeoA3's PointNet;
  * the defenses SRS, SOR and jitter, at attack time
    (``--defense_method``: the attack differentiates through it, and the
    judging sees it too) and at eval time (``--eval_defense_method``: the
    judging alone);
  * the parallel modes, each on ranks that `main` starts itself
    (`parallel.spawn`: one process per device, rank r on ``cuda:r`` over
    NCCL, or on the CPU over gloo; rank 0 prints): ``--n_devices N``
    splits each batch over N ranks (`parallel.shard_attack`);
    ``--restarts R`` runs R independent restarts of each batch and keeps
    each example's first success (`parallel.population_attack`), over
    the largest number of the machine's CUDA devices that divides R, or
    in turn on one; ``--sp_devices D`` with ``--dist_func chamfer``
    shards CW-Perturb's Chamfer distance over a D-rank ring
    (`parallel.ring_chamfer`). More ranks than CUDA devices raise (the
    JAX `eval` takes the devices it finds). Called inside an initialised
    process group of the right size, `main` runs as this rank of it;
  * ``--spans PATH`` turns on the evaluation's spans and counters
    (`utils.profiling`) and writes their summary to ``PATH`` as JSON
    (rank 0), as ``--resume PATH`` keeps a sweep's progress.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from hitadv_torch import resolve_device
from hitadv_torch.config import EvalConfig, add_config_flags, config_from_args


# the FGM family's registry names -> their makers in `attacks`
_FGM_MAKERS = {"fgsm": "make_fgsm", "ifgsm": "make_ifgsm",
               "mifgsm": "make_mifgsm", "pgd": "make_pgd",
               "fgsm-rs": "make_fgsm_rs", "fgm-l2": "make_fgm_l2",
               "ifgm-l2": "make_ifgm_l2"}


# the JAX `eval`'s refusals of the parallel flags together
# (`hitadv_tpu/eval.py`: `_cw_dist_fn` and `main`)
RING_AND_BATCH = (
    "--sp_devices (points sharded over a ring mesh) and"
    " --n_devices (batch-sharded attack) are mutually"
    " exclusive: the ring's shard_map closes over its"
    " own mesh and cannot nest inside the dp-sharded"
    " program — pick one axis to shard")
RESTARTS_AND_MESH = (
    "--restarts shards the restart axis over the mesh and is"
    " mutually exclusive with --n_devices (batch sharding)"
    " and --sp_devices (points-sharded ring) — one mesh axis"
    " per attack program")
CW_PERTURB = ("cw-perturb", "cw-perturbt", "cw-uperturb")


def uses_ring(cfg: EvalConfig) -> bool:
    """Whether the attack takes CW-Perturb's ring Chamfer distance
    (``--dist_func chamfer --sp_devices D`` with D > 1)."""
    name = cfg.attack_type.lower().replace("_", "-")
    return (name in CW_PERTURB and cfg.dist_func == "chamfer"
            and (cfg.sp_devices or 0) > 1)


def check_parallel_flags(cfg: EvalConfig) -> None:
    """The JAX `eval`'s `ValueError`s for parallel flags that exclude
    each other."""
    batch = (cfg.n_devices or 0) > 1
    if (cfg.restarts or 0) > 1 and (batch or (cfg.sp_devices or 0) > 1):
        raise ValueError(RESTARTS_AND_MESH)
    if uses_ring(cfg) and batch:
        raise ValueError(RING_AND_BATCH)


def mesh_size(cfg: EvalConfig) -> int:
    """The number of ranks the flags ask for: ``--n_devices``; the ring's
    ``--sp_devices``; for ``--restarts R``, the largest number of the
    machine's CUDA devices that divides R (one on the CPU), as the JAX
    `eval`'s restart mesh; else 1."""
    check_parallel_flags(cfg)
    if (cfg.restarts or 0) > 1:
        have = (torch.cuda.device_count()
                if torch.device(cfg.device).type == "cuda" else 1)
        return max(k for k in range(1, have + 1) if cfg.restarts % k == 0)
    if (cfg.n_devices or 0) > 1:
        return cfg.n_devices
    return cfg.sp_devices if uses_ring(cfg) else 1


def build_model(cfg: EvalConfig) -> torch.nn.Module:
    """The victim on ``cfg.device`` (reference `eval.py:105-124`): a fresh
    initialisation from ``cfg.seed``, or ``--checkpoint``, a pickled
    parameter tree (``.pkl``) or the reference's torch checkpoint; bf16
    activations with ``--bf16``."""
    from hitadv_torch import models
    from hitadv_torch.convert import params_from_numpy, tree_from_torch
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
        tree = tree_from_torch(cfg.model, cfg.checkpoint)
    return cls(params=params_from_numpy(tree, dev), **kw)


def _cw_dist_fn(cfg: EvalConfig):
    """CW-Perturb's distance: the reference's L2 (None) by default, the
    Chamfer distance with ``--dist_func chamfer``, and with
    ``--sp_devices D`` > 1 the Chamfer distance with the points sharded
    over the D ranks of the process group (`parallel.ring_chamfer`), the
    large-N configuration."""
    from hitadv_torch import losses

    if cfg.dist_func in (None, "l2"):
        return None
    if cfg.dist_func != "chamfer":
        raise ValueError(f"dist_func {cfg.dist_func!r}")
    if (cfg.sp_devices or 0) > 1:
        if (cfg.n_devices or 0) > 1:
            raise ValueError(RING_AND_BATCH)
        from hitadv_torch.parallel import make_mesh, ring_chamfer

        sp = make_mesh(cfg.sp_devices)
        return lambda adv, ori: ring_chamfer(adv, ori, sp)
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
    """``(points [B, N, C], labels [B])`` numpy batches (JAX
    `build_batches`): ``--dataset ModelNet`` (`data.ModelNetDataset` with
    ``--use_normals``, ``--num_category``, ``--use_uniform_sample`` and
    ``--process_data``) or ``ShapeNetPart`` (`data.PartNormalDataset`,
    normals on) from ``--data_path``, in order through
    `data.batch_iterator` with ``--num_workers`` threads; or the
    synthetic batches. A real dataset without ``--data_path`` raises."""
    from hitadv_torch import data

    if cfg.dataset == "synthetic":
        n_batches = max(1, cfg.synthetic_size // cfg.batch_size)
        return data.synthetic_batches(n_batches, cfg.batch_size,
                                      cfg.num_point, cfg.num_class,
                                      seed=cfg.seed)
    if cfg.dataset not in ("ModelNet", "ShapeNetPart"):
        raise ValueError(f"dataset {cfg.dataset!r}")
    if cfg.data_path is None:
        raise ValueError(
            f"--dataset {cfg.dataset} needs --data_path: the port runs no "
            "synthetic stand-in for it (ROADMAP.md §3)")
    if cfg.dataset == "ModelNet":
        ds = data.ModelNetDataset(
            cfg.data_path, num_points=cfg.num_point, split="test",
            use_normals=cfg.use_normals, num_category=cfg.num_category,
            uniform=cfg.use_uniform_sample, process_data=cfg.process_data)
    else:
        ds = data.PartNormalDataset(cfg.data_path, npoints=cfg.num_point,
                                    split="test", normal_channel=True)
    return data.batch_iterator(ds, cfg.batch_size, shuffle=False,
                               num_workers=cfg.num_workers)


def parse_args(argv=None) -> Tuple[EvalConfig, argparse.Namespace]:
    """The command line's `EvalConfig` and its parsed arguments (the
    config's flags, ``--resume`` and ``--spans``)."""
    parser = argparse.ArgumentParser("hitadv_torch eval")
    add_config_flags(parser)
    parser.add_argument("--resume", default=None,
                        help="progress file for resumable sweeps")
    parser.add_argument("--spans", default=None,
                        help="record spans and counters and write their "
                        "summary (utils.profiling.summary) to this JSON file")
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


def run(cfg: EvalConfig, args: argparse.Namespace) -> dict:
    """The evaluation of ``cfg`` in this process: alone, or as a rank of
    the initialised process group when the flags ask for more than one
    (`mesh_size`), every rank taking rank 0's batches; only rank 0
    prints and writes the log, ``--resume`` and ``--spans`` files."""
    import torch.distributed as dist

    from hitadv_torch.data import device_put_batches
    from hitadv_torch.evaluation import eval_asr
    from hitadv_torch.parallel import (
        make_mesh,
        population_attack,
        shard_attack,
    )
    from hitadv_torch.utils import EvalProgress
    from hitadv_torch.utils import profiling

    dev = resolve_device(cfg.device)
    n, group = mesh_size(cfg), None
    if n > 1:
        if not dist.is_initialized() or dist.get_world_size() != n:
            raise RuntimeError(
                f"hitadv_torch.eval: the flags ask for {n} ranks; call "
                "main, which starts them, or run inside a process group "
                "of that size")
        group = make_mesh()
    lead = group is None or dist.get_rank(group) == 0

    model = build_model(cfg)
    logits_fn, eval_logits_fn = defended(cfg, model, dev)
    # rank 0 builds its attack first: an AE it fits and caches is then
    # loaded by the others, never read while it is being written
    if not lead:
        dist.barrier(group)
    attack = build_attack(cfg, logits_fn, model)
    if lead and group is not None:
        dist.barrier(group)
    if (cfg.restarts or 0) > 1:
        attack = population_attack(attack, cfg.restarts, group)
    elif (cfg.n_devices or 0) > 1:
        attack = shard_attack(attack, group)
    batches = build_batches(cfg)
    if cfg.max_batches:
        batches = itertools.islice(batches, cfg.max_batches)
    batches = device_put_batches(batches, dev, group)
    progress = (EvalProgress(args.resume, write=lead) if args.resume
                else None)
    if args.spans:
        profiling.reset()
        profiling.enable(dev)
    try:
        metrics = eval_asr(eval_logits_fn, attack, batches, seed=cfg.seed,
                           uniform_k=cfg.k,
                           log_dir=cfg.log_dir if lead else None,
                           progress=progress, device=dev)
    finally:
        if args.spans:
            profiling.disable()
    if args.spans and lead:
        profiling.collect()
        with open(args.spans, "w") as f:
            json.dump(profiling.summary(), f, indent=1)
    if lead:
        print({k: round(float(v), 6) for k, v in metrics.items()})
    return metrics


def _run_rank(rank: int, argv) -> dict:
    """A rank started by `main`: on ``cuda:rank`` when the flags ask for
    the card."""
    cfg, args = parse_args(argv)
    if torch.device(cfg.device).type == "cuda":
        torch.cuda.set_device(rank)
        cfg.device = f"cuda:{rank}"
    return run(cfg, args)


def main(argv=None) -> dict:
    """The evaluation of the command line ``argv``; where its flags ask
    for more than one rank and no process group is initialised, on that
    many new processes (`parallel.spawn`), returning rank 0's metrics."""
    import torch.distributed as dist

    from hitadv_torch.parallel import mesh

    argv = sys.argv[1:] if argv is None else list(argv)
    cfg, args = parse_args(argv)
    n = mesh_size(cfg)
    if n > 1 and not dist.is_initialized():
        resolve_device(cfg.device)
        mesh.check_devices(n, cfg.device)
        return mesh.spawn(_run_rank, n, (argv,),
                          backend=mesh.backend_for(cfg.device))
    return run(cfg, args)


if __name__ == "__main__":
    main()
