"""The evaluation's typed configuration (port of `hitadv_tpu/config.py`).

One dataclass replaces the reference's argparse modules (`config.py`,
`eval.py:21-72`, `FGM/CWPert_args.py`, ...); its defaults are the
hyperparameters of record of the HiT-ADV evaluation. The port adds one
field, ``device``: the entry point runs on the card unless the caller
passes ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class EvalConfig:
    # data (`eval.py:26,41,61-63`)
    dataset: str = "ModelNet"          # ModelNet | ShapeNetPart | synthetic
    data_path: Optional[str] = None
    batch_size: int = 256
    num_point: int = 1024
    num_class: int = 40
    num_category: int = 40
    use_normals: bool = True
    use_uniform_sample: bool = False
    process_data: bool = False
    num_workers: int = 10

    # victim (`eval.py:44`)
    model: str = "pointnet"
    checkpoint: Optional[str] = None   # torch checkpoint or pickled tree
    emb_dims: int = 1024
    dropout: float = 0.2
    k: int = 5                         # DGCNN k AND uniform-metric k

    # attack selection (`eval.py:34,28-37`)
    attack_type: str = "HiT-ADV"
    adv_func: str = "cross_entropy"    # cross_entropy | logits
    kappa: float = 30.0
    budget: float = 0.55
    num_iter: int = 100
    mu: float = 1.0
    step_size: Optional[float] = None  # default budget*2/num_iter

    # CW loop (`FGM/CWPert_args.py:39-44`)
    attack_lr: float = 1e-2
    binary_step: int = 10
    init_weight: float = 10.0
    max_weight: float = 80.0

    # SaliencyDrop (`Saliency/Drop.py:16`): points to delete
    num_drop: int = 200

    # HiT-ADV specifics (`eval.py:49-59`)
    cd_weight: float = 1e-4
    ker_weight: float = 1.0
    hide_weight: float = 1.0
    curv_loss_knn: int = 16
    central_num: int = 192
    total_central_num: int = 256
    max_sigm: float = 1.2
    min_sigm: float = 0.1

    # AdvPC / UAEAOF autoencoder (`CW/AdvPC.py:83-99`); read by those
    # attacks, which the port does not have yet
    ae_checkpoint: Optional[str] = None
    ae_fit_steps: int = 300

    # defenses (`eval.py:64-66`): srs | sor | jitter, at attack time
    # (the attack differentiates through it) and at eval time (the judging
    # alone)
    defense_method: Optional[str] = None
    eval_defense_method: Optional[str] = None

    # precision: bf16 activations between layers (the models'
    # compute_dtype)
    bf16: bool = False

    # eval harness
    seed: int = 0
    log_dir: str = "./log"
    max_batches: Optional[int] = None  # cap for smoke runs
    n_devices: Optional[int] = None    # mesh size; > 1 raises (not ported)
    synthetic_size: int = 64           # items when dataset == synthetic

    # CW-Perturb distance: None/"l2" = the reference's L2, "chamfer" = the
    # set distance; sp_devices > 1 (its points sharded over a ring mesh)
    # raises, not ported yet
    dist_func: Optional[str] = None
    sp_devices: int = 0

    # population parallelism: R independent restarts of the same batch;
    # R > 1 raises, not ported yet
    restarts: int = 0

    # where the evaluation runs: "cuda" unless the caller asks for "cpu"
    device: str = "cuda"


def add_config_flags(parser: argparse.ArgumentParser,
                     cfg_cls=EvalConfig) -> None:
    """Auto-generate CLI flags from the dataclass fields."""
    for f in dataclasses.fields(cfg_cls):
        name = "--" + f.name
        ann = str(f.type)
        if f.type in ("bool", bool) or "bool" in ann:
            parser.add_argument(name, type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=f.default)
        elif f.default is None or isinstance(f.default, (int, float, str)):
            if f.default is not None:
                typ = type(f.default)
            elif "int" in ann:                  # Optional[int]
                typ = int
            elif "float" in ann:                # Optional[float]
                typ = float
            else:
                typ = str
            parser.add_argument(name, type=typ, default=f.default)


def config_from_args(args: argparse.Namespace,
                     cfg_cls=EvalConfig) -> EvalConfig:
    kwargs = {f.name: getattr(args, f.name)
              for f in dataclasses.fields(cfg_cls)
              if hasattr(args, f.name)}
    return cfg_cls(**kwargs)
