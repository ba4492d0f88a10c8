"""The step check of IFGSM: the victim's inputs during the attack are
its iterates, so the start (call 0), a step drawn from the seed and the
last step (calls t, t + 1, the second-to-last and the last) are kept,
and the reference takes each kept step again from the program's
iterate. A cloud's error is the share of its coordinates where the two
next iterates differ. Exact: a cloud whose start is not the clean cloud
within 1e-5, or whose answer is not the last iterate."""

from __future__ import annotations

import numpy as np
import torch

from bench_port.reference import ifgsm


def plan(traffic: dict, rng: np.random.Generator) -> dict:
    n = traffic["attack"]["num_iter"]
    t = int(rng.integers(0, n - 1))
    return {"t": t, "keep": {0, t, t + 1, n - 1, n}, "x": {}}


def install(rec):
    return None


def uninstall(hooks) -> None:
    pass


def on_victim_call(step: dict, i: int, x: torch.Tensor) -> None:
    if i in step["keep"]:
        step["x"][i] = x.detach()


def readings(batch, cell, params, forward, block: int, seed: int,
             control=None):
    """``(per-cloud errors of the kept steps of batch, clouds off the
    exact rules)``. With ``control`` (a context manager), the reference
    under it stands in the program's place: its next iterates are judged
    instead of the program's, and the exact rules are not read."""
    a = cell.traffic["attack"]
    n, budget = a["num_iter"], a["budget"]
    size = a["step_size"] if a.get("step_size") is not None \
        else budget * 2.0 / n
    xs, t = batch.step["x"], batch.step["t"]
    ori = batch.points[..., :3]
    labels = batch.labels.long()
    if set(xs) != batch.step["keep"]:       # the attack skipped the victim
        return np.ones(ori.shape[0], np.float32), ori.shape[0]
    start = xs[0]
    err = torch.zeros(ori.shape[0], device=ori.device)
    for i in sorted({t, n - 1}):
        ref = ifgsm.step(forward, params, cell.config, xs[i], start, labels,
                         size, budget, block)
        got = xs[i + 1]
        if control is not None:
            with control():
                got = ifgsm.step(forward, params, cell.config, xs[i], start,
                                 labels, size, budget, block)
        err = torch.maximum(err, (got != ref).float().mean(dim=(1, 2)))
    bad = (start - ori).abs().amax(dim=(1, 2)) > 1e-5
    bad |= (batch.result.adv_points != xs[n]).any(dim=2).any(dim=1)
    return err.cpu().numpy(), int(bad.sum())
