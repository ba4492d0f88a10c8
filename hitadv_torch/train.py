"""Victim training: ``python -m hitadv_torch.train``.

Port of `hitadv_tpu/train.py`: a cross-entropy Adam loop over any
registered victim with train-mode BatchNorm. The forward runs inside
`functional.bn_training`, so every BN normalises with its batch
statistics, and after each step the running statistics move the torch
way (momentum 0.1, unbiased variance); the trained parameters then drop
straight into the eval-mode attack paths. The tree is saved in the
layout both packages read (`utils.checkpoint.save_params`), so
``python -m hitadv_torch.eval --checkpoint`` (or the JAX package) attacks
it.

The weights ask for a gradient only inside a step: outside it the victim
is frozen again, as the attacks expect. Training runs on the card unless
``--device cpu`` is given, where the kernels' plain versions run.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from hitadv_torch import resolve_device
from hitadv_torch.attacks.base import AdamState, adam_init, adam_update
from hitadv_torch.losses import cross_entropy_loss
from hitadv_torch.nn import functional as F

_BN_KEYS = frozenset(("scale", "bias", "mean", "var"))
# the running statistics' EMA weight, in torch's convention: after a step
# ``running = (1 - BN_MOMENTUM) running + BN_MOMENTUM batch``
BN_MOMENTUM = 0.1


def _is_bn(module: nn.Module) -> bool:
    return isinstance(module, nn.ParameterDict) and set(module) == _BN_KEYS


def trainable(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The leaves the optimiser moves, by path (``"stn.fc1.w"``): every
    parameter but the BN running statistics, which move by their EMA (the
    JAX step hands them zero gradients, which Adam turns into zero
    updates)."""
    out = {}
    for name, module in model.params.named_modules():
        if not isinstance(module, nn.ParameterDict):
            continue
        for key, p in module.items():
            if not (_is_bn(module) and key in ("mean", "var")):
                out[f"{name}.{key}" if name else key] = p
    return out


def param_tree(model: nn.Module) -> Dict:
    """The model's parameters as nested dicts of detached tensors, in the
    tree layout of both packages (for `utils.checkpoint.save_params`)."""
    def walk(m):
        if isinstance(m, nn.ParameterDict):
            return {k: v.detach() for k, v in m.items()}
        return {k: walk(v) for k, v in m.items()}
    return walk(model.params)


class Adam:
    """Adam at ``lr`` (b1 0.9, b2 0.999, eps 1e-8: ``optax.adam(lr)``'s
    update, as the JAX trainer's) over named leaves, each stepped in place
    by `attacks.base.adam_update`; a leaf's moments start at zero when it
    is first handed over."""

    def __init__(self, lr: float):
        self.lr = lr
        self.states: Dict[str, AdamState] = {}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> None:
        for name, p in params.items():
            new, self.states[name] = adam_update(
                grads[name], self.states.get(name) or adam_init(p), p,
                self.lr)
            p.copy_(new)


def _deterministic_cudnn():
    """cuDNN restricted to its deterministic algorithms, its other
    settings kept: the weight gradient of a general conv (GeoA3's
    kernel-3 ``conv5``) may otherwise sum in a run-dependent order, and a
    repeated training run must give the same tree bit for bit."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   deterministic=True, allow_tf32=c.allow_tf32)


class StepResult(NamedTuple):
    loss: torch.Tensor            # [] mean cross-entropy of the batch
    acc: torch.Tensor             # [] share of correct predictions
    logits: torch.Tensor          # [B, classes], the train-mode forward's
    grads: Dict[str, torch.Tensor]            # by `trainable` path
    stats: List[Tuple[str, torch.Tensor, torch.Tensor]]  # BN path, mean,
    #                                            unbiased variance


def make_train_step(model: nn.Module, optimizer: Adam,
                    frozen_bn: bool = False):
    """``step(x, y) -> StepResult``: one optimiser step of ``model`` on the
    batch (reference :49-112), in place.

    The forward runs inside `functional.bn_training`: every BN normalises
    with batch statistics and records its batch mean and unbiased
    variance; after the optimiser's update each recorded BN's running
    statistics become ``(1 - m) old + m batch`` (m = `BN_MOMENTUM`).
    ``frozen_bn=True`` runs
    the running statistics in the forward and never updates them (the
    reference's ablation; they take no gradient step either)."""
    paths = {id(m): name for name, m in model.params.named_modules()}

    def step(x: torch.Tensor, y: torch.Tensor) -> StepResult:
        leaves = trainable(model)
        records: list = []
        for p in leaves.values():
            p.requires_grad_(True)
        try:
            with _deterministic_cudnn():
                if frozen_bn:
                    logits = model(x)
                else:
                    with F.bn_training(records):
                        logits = model(x)
                loss = torch.mean(cross_entropy_loss(logits, y))
                got = torch.autograd.grad(loss, list(leaves.values()),
                                          allow_unused=True)
        finally:
            for p in leaves.values():
                p.requires_grad_(False)
        grads = {name: torch.zeros_like(p) if g is None else g
                 for (name, p), g in zip(leaves.items(), got)}
        optimizer.update(leaves, grads)
        stats = []
        with torch.no_grad():
            m = BN_MOMENTUM
            for bn, bm, bv in records:
                bn["mean"].copy_((1 - m) * bn["mean"] + m * bm)
                bn["var"].copy_((1 - m) * bn["var"] + m * bv)
                stats.append((paths[id(bn)], bm, bv))
        logits = logits.detach()
        acc = torch.mean((torch.argmax(logits, -1) == y).float())
        return StepResult(loss.detach(), acc, logits, grads, stats)

    return step


def train_victim(model: nn.Module, clouds: np.ndarray, labels: np.ndarray,
                 epochs: int = 30, batch_size: int = 16, lr: float = 1e-3,
                 verbose: bool = False) -> nn.Module:
    """Train ``model`` in place on (clouds ``[M, N, C]``, labels ``[M]``)
    (reference :115-140): Adam at ``lr``, each epoch a permutation from
    one ``RandomState(0)``, whole batches only (the last partial one is
    dropped). Returns the model."""
    dev = next(model.parameters()).device
    step = make_train_step(model, Adam(lr))
    n = len(labels)
    rng = np.random.RandomState(0)
    clouds_t = torch.from_numpy(np.ascontiguousarray(clouds,
                                                     np.float32)).to(dev)
    labels_t = torch.from_numpy(np.asarray(labels)).to(dev).long()
    for epoch in range(epochs):
        order = rng.permutation(n)
        accs = []
        for i in range(0, n - batch_size + 1, batch_size):
            idx = torch.from_numpy(order[i:i + batch_size]).to(dev)
            accs.append(step(clouds_t[idx], labels_t[idx]).acc)
        if verbose:
            acc = torch.stack(accs).mean().item() if accs else float("nan")
            print(f"epoch {epoch}: acc {acc:.3f}")
    return model


def build_victim(name: str, num_class: int, seed: int, device) -> nn.Module:
    """A freshly initialised victim ``name`` on ``device``, its weights
    drawn from a generator seeded with ``seed`` there."""
    from hitadv_torch import models

    dev = resolve_device(device)
    return models.get_model(name)(
        num_class, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("hitadv_torch train")
    p.add_argument("--model", default="pointnet")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--num_train", type=int, default=512)
    p.add_argument("--num_point", type=int, default=1024)
    p.add_argument("--num_class", type=int, default=40)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--out", default="victim.pkl")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default: the kernels) or cpu (their "
                        "plain versions)")
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> nn.Module:
    """Train ``--model`` on ``--num_train`` synthetic clouds and save its
    tree to ``--out`` (reference :143-169); returns the model."""
    from hitadv_torch.data import synthetic_clouds
    from hitadv_torch.utils import checkpoint as ckpt

    args = parse_args(argv)
    model = build_victim(args.model, args.num_class, args.seed, args.device)
    pts, labels = synthetic_clouds(args.num_train, args.num_point,
                                   args.num_class, seed=args.seed)
    train_victim(model, pts[..., :3], labels, epochs=args.epochs,
                 batch_size=args.batch_size, lr=args.lr, verbose=True)
    ckpt.save_params(args.out, param_tree(model))
    print(f"saved {args.out}")
    return model


if __name__ == "__main__":
    main()
