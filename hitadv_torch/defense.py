"""Input-transformation defenses (port of `hitadv_tpu/defense.py`).

The reference declares ``--defense_method`` / ``--eval_defense_method``
(`eval.py:64-66`) without implementing them; its attacks accept a
``pre_head`` transform (`CW/Perturb.py:99-101`). These are the standard
point-cloud defenses for that hook, with fixed shapes:
  * SRS, simple random sampling: drop random points;
  * SOR, statistical outlier removal (DUP-Net's front end): points whose
    mean kNN distance exceeds mean + alpha std snap onto their nearest
    neighbour;
  * Gaussian jitter.
A removed point becomes a copy of a surviving one (a duplicate is the
same as a deletion for the max-pool victims).

Each defense is a fixed function, as in the reference: SRS's
permutations and the jitter are drawn once per cloud shape from the
defense's seeded generator and reused on every call (the reference folds
N into one key and draws from it on every call), or pinned by the caller.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from hitadv_torch import resolve_device
from hitadv_torch.ops import geometry as G


class _PerShape:
    """A draw per cloud shape ``(B, N, C)``: pinned ones, else ``draw(B, N,
    C)`` the first time the shape comes, kept for every later call."""

    def __init__(self, draw: Callable, pinned: Optional[torch.Tensor]):
        self.draw = draw
        self.cache: Dict[Tuple[int, ...], torch.Tensor] = {}
        self.pinned = pinned

    def get(self, B: int, N: int, C: int, dev) -> torch.Tensor:
        if self.pinned is not None:
            return self.pinned.to(dev)
        if (B, N, C) not in self.cache:
            self.cache[(B, N, C)] = self.draw(B, N, C)
        return self.cache[(B, N, C)]


def make_srs(drop_num: int, generator: Optional[torch.Generator] = None, *,
             permutations=None) -> Callable:
    """Simple random sampling: keep ``max(N - drop_num, 1)`` points of a
    random permutation of each cloud and pad back to N with the kept
    points in turn (``kept[:, arange(N - keep) % keep]``), one row gather.
    ``permutations`` ``[B, N]`` pins the permutations of clouds of that
    shape; else ``generator`` draws one permutation per cloud and shape."""
    pinned = (None if permutations is None
              else torch.as_tensor(permutations).long())

    def draw(B, N, C):
        u = torch.rand((B, N), generator=generator, device=generator.device)
        return torch.argsort(u, dim=1)

    perms = _PerShape(draw, pinned)

    def srs(pc: torch.Tensor) -> torch.Tensor:
        B, N, C = pc.shape
        keep = max(N - drop_num, 1)
        perm = perms.get(B, N, C, pc.device)
        if perm.shape != (B, N):
            raise ValueError(f"srs: permutations {tuple(perm.shape)} for a "
                             f"cloud {tuple(pc.shape)}")
        pad = torch.arange(N - keep, device=pc.device) % keep
        idx = torch.cat([perm[:, :keep], perm[:, :keep][:, pad]], dim=1)
        return G.index_points(pc, idx.to(torch.int32))

    return srs


def make_sor(k: int = 2, alpha: float = 1.1) -> Callable:
    """Statistical outlier removal: the points whose mean distance to
    their k nearest others exceeds ``mean + alpha std`` (unbiased std)
    snap onto their nearest neighbour."""

    def sor(pc: torch.Tensor) -> torch.Tensor:
        dists, idx = G.knn_indices(pc, k)                    # squared
        value = torch.mean(torch.sqrt(torch.clamp_min(dists, 0.0)), dim=-1)
        mean = torch.mean(value, dim=-1, keepdim=True)
        std = torch.std(value, dim=-1, keepdim=True, correction=1)
        outlier = value > mean + alpha * std                 # [B, N]
        nn_pts = G.index_points(pc, idx[..., 0])
        return torch.where(outlier[..., None], nn_pts, pc)

    return sor


def make_jitter(sigma: float = 0.01, clip: float = 0.05,
                generator: Optional[torch.Generator] = None, *,
                noise=None) -> Callable:
    """Gaussian jitter ``pc + clamp(sigma N(0, 1), -clip, clip)``: the same
    noise for every cloud of a shape, drawn once from ``generator`` or
    pinned by ``noise`` (the unit normal draw, of the cloud's shape)."""
    pinned = (None if noise is None
              else torch.as_tensor(noise, dtype=torch.float32))

    def draw(B, N, C):
        return torch.randn((B, N, C), generator=generator,
                           device=generator.device)

    unit = _PerShape(draw, pinned)

    def jitter(pc: torch.Tensor) -> torch.Tensor:
        n = unit.get(*pc.shape, pc.device)
        return pc + torch.clamp(sigma * n, -clip, clip)

    return jitter


def get_defense(name: Optional[str],
                generator: Optional[torch.Generator] = None,
                device="cuda") -> Optional[Callable]:
    """The defense ``--defense_method`` names: None for None, "" , "none"
    or "null"; "srs" (500 points dropped), "sor" or "jitter". The random
    ones draw from ``generator``, by default one seeded with 0 on
    ``device``."""
    if not name or name.lower() in ("none", "null"):
        return None
    name = name.lower()
    if name not in ("srs", "sor", "jitter"):
        raise ValueError(f"unknown defense {name!r}")
    if generator is None:
        generator = torch.Generator(
            device=resolve_device(device)).manual_seed(0)
    if name == "srs":
        return make_srs(500, generator)
    if name == "sor":
        return make_sor()
    return make_jitter(generator=generator)


def defended_logits_fn(logits_fn: Callable,
                       defense: Optional[Callable]) -> Callable:
    """``logits_fn(defense(x))``, the reference's ``model(self.pre_head(
    adv_data))``; ``logits_fn`` itself without a defense."""
    if defense is None:
        return logits_fn
    return lambda x: logits_fn(defense(x))
