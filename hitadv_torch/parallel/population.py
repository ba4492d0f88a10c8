"""Population parallelism: independent restarts of one batch (port of
`hitadv_tpu/parallel/population.py`).

The reference's restarts are sequential and their math is independent
given different random streams, so R restarts of the SAME batch can run
side by side and keep, per example, the first successful adversarial
cloud. On one device they run in turn; over a process group the
restarts are split among the ranks (the JAX package shards its restart
axis over a device mesh the same way) and their results gathered.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from hitadv_torch.parallel import comm


def restart_generators(generator: torch.Generator, n_restarts: int
                       ) -> List[torch.Generator]:
    """The generators of the restarts, on ``generator``'s device, seeded
    by ``n_restarts`` draws from it (the JAX package splits the batch's
    key). Reading the seeds is the only host sync, before any restart
    runs."""
    seeds = torch.randint(0, 2 ** 62, (n_restarts,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=generator.device).manual_seed(s)
            for s in seeds]


def population_attack(attack_fn: Callable, n_restarts: int,
                      group=None) -> Callable:
    """Wrap an attack to run ``n_restarts`` independent instances on the
    same batch, restart r with the r-th of `restart_generators`.

    Selection per example, on the device: the cloud and prediction of
    the first restart (in restart order) that succeeded; where none did,
    restart 0's; success is the OR over the restarts. With ``group``
    (whose size must divide ``n_restarts``), rank k runs the k-th
    contiguous block of restarts, and the ranks' results are gathered
    before the selection, which every rank makes alike.
    """
    D = 1 if group is None else comm.world(group)
    if n_restarts % D:
        raise ValueError(f"population_attack: {n_restarts} restarts over "
                         f"{D} ranks")
    per = n_restarts // D

    def attack(points, labels, generator: torch.Generator):
        gens = restart_generators(generator, n_restarts)
        k = 0 if group is None else comm.rank(group)
        runs = [attack_fn(points, labels, g)
                for g in gens[k * per:(k + 1) * per]]
        adv, success, pred = (torch.stack(list(t)) for t in zip(*runs))
        if group is not None:                       # [R, B, ...] in order
            adv, success, pred = (comm.all_gather(t, group)
                                  for t in (adv, success, pred))
        first = torch.argmax(success.to(torch.uint8), dim=0)       # [B]
        any_ok = torch.any(success, dim=0)
        pick = torch.where(any_ok, first, torch.zeros_like(first))
        rows = torch.arange(success.shape[1], device=success.device)
        return runs[0]._replace(adv_points=adv[pick, rows],
                                success=any_ok, pred=pred[pick, rows])

    return attack
