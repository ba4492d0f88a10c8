"""The step check of HiT-ADV. `hitadv_torch.attacks.hit_adv.make_inner_iter`
is wrapped for the window, so that each attack's prepared centres and
one Adam iteration drawn from the seed (its state before and after) are
kept by reference. The reference prepares the centres itself from the
clean cloud, with the FPS start drawn as the attack draws it (the first
draw of the batch's generator), and takes that iteration from the
program's state. A cloud's error is the larger of the relative L2 gaps
of the translations' and of the widths' Adam updates, and the largest
gap of the deformed cloud over its largest displacement. Exact: a cloud
whose best-so-far records differ where both sides chose the same centres
and the reference's prediction has a clear winner (top two logits apart
by more than 1e-5 of the largest); whose loss weight at the start of a
binary step is not the one the reference's search gives from the
program's records at the end of the steps before; whose success flag
is not whether its best record over all steps holds a success, or not
the reference's search's; or whose answer is not that record where it
holds one and the last deformed cloud elsewhere. A cloud whose centres a
near tie of the scores flips (about one in three thousand) reads a large
error; the limit's statistic reads past a few such clouds."""

from __future__ import annotations

import numpy as np
import torch

from bench_port.reference import hitadv as H


def plan(traffic: dict, rng: np.random.Generator) -> dict:
    return {"t": int(rng.integers(0, traffic["iterations_per_batch"])),
            "weights": [], "ends": []}


def install(rec):
    from hitadv_torch.attacks import hit_adv

    real = hit_adv.make_inner_iter
    last = rec.traffic["iterations_per_batch"] - 1
    n = rec.traffic["attack"]["num_iter"]

    def make_inner_iter(logits_fn, adv_fn, cfg, ori, labels, central_points,
                        central_kappa_std, *args, **kw):
        inner = real(logits_fn, adv_fn, cfg, ori, labels, central_points,
                     central_kappa_std, *args, **kw)
        step = rec.current.step
        step["centrals"] = central_points
        count = [0]

        def wrapped(s):
            out = inner(s)
            if count[0] % n == 0:           # a binary step's first
                step["weights"].append(s.weight)
            if count[0] % n == n - 1:       # and its last iteration
                step["ends"].append((out.best.score, out.best.dist,
                                     out.o_best.dist))
            if count[0] == step["t"]:
                step["in"], step["out"] = s, out
            if count[0] == last:
                step["final"] = out
            count[0] += 1
            return out
        return wrapped

    hit_adv.make_inner_iter = make_inner_iter
    return real


def uninstall(real) -> None:
    from hitadv_torch.attacks import hit_adv

    hit_adv.make_inner_iter = real


def on_victim_call(step: dict, i: int, x: torch.Tensor) -> None:
    pass


def eval_batch_seed(seed: int, index: int) -> int:
    """The seed of batch ``index``'s generator in the evaluation: the
    first word of numpy's SeedSequence of ``(seed, index)``."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


def _adam(s):
    return H.Adam(s.step, s.mu, s.nu)


def _best(b):
    return H.Best(b.dist, b.score, b.adv)


def readings(batch, cell, params, forward, block: int, seed: int,
             control=None):
    """``(per-cloud errors, clouds off the exact rules)`` of the kept
    iteration of ``batch``; with ``control``, the reference under it in
    the program's place, and the exact rules not read."""
    cfg = dict(cell.traffic["attack"])
    points, labels = batch.points, batch.labels.long()
    ori, normal = points[..., :3].contiguous(), points[..., 3:6]
    B, N = ori.shape[:2]
    gen = torch.Generator(device=ori.device).manual_seed(
        eval_batch_seed(seed, batch.index))
    start = torch.randint(0, N, (B,), generator=gen, device=ori.device,
                          dtype=torch.int32)
    if not {"in", "out", "final"} <= set(batch.step):  # no such iteration
        return np.ones(B, np.float32), B
    s_in, s_out = batch.step["in"], batch.step["out"]

    def iterate():
        centrals = H.prepare(forward, params, cell.config, ori, normal,
                             labels, start, cfg, block)
        return centrals, H.iterate(
            forward, params, cell.config, ori, labels, centrals, s_in.pert,
            s_in.delta, _adam(s_in.opt_p), _adam(s_in.opt_d), s_in.weight,
            _best(s_in.best), _best(s_in.o_best), cfg, block)

    centrals, ref = iterate()
    if control is not None:
        with control():
            _, got = iterate()
        got_pert, got_delta, got_def = got.pert, got.delta, got.deformed
        got_best, got_obest = got.best, got.o_best
    else:
        got_pert, got_delta, got_def = s_out.pert, s_out.delta, s_out.last
        got_best, got_obest = _best(s_out.best), _best(s_out.o_best)
    p0 = torch.clamp(s_in.pert, -cfg["budget"], cfg["budget"])
    d0 = torch.clamp(s_in.delta, cfg["min_sigm"], cfg["max_sigm"])

    def rel(got, want, base, dims):
        num = torch.linalg.vector_norm(got - want, dim=dims)
        return num / torch.clamp_min(
            torch.linalg.vector_norm(want - base, dim=dims), 1e-30)

    err = torch.maximum(rel(got_pert, ref.pert, p0, (1, 2)),
                        rel(got_delta, ref.delta, d0, (1,)))
    disp = (ref.deformed - ori).abs().amax(dim=(1, 2))
    err = torch.maximum(err, (got_def - ref.deformed).abs().amax(dim=(1, 2))
                        / torch.clamp_min(disp, 1e-30))
    top2 = torch.topk(ref.logits, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5 * ref.logits.abs().amax(-1)
    differ = torch.zeros_like(clear)
    for mine, theirs in ((got_best, ref.best), (got_obest, ref.o_best)):
        differ |= mine.score.long() != theirs.score.long()
        differ |= (mine.dist - theirs.dist).abs() > 1e-5 * theirs.dist.abs()
    same_centres = (batch.step["centrals"] == centrals.points).all(
        dim=2).all(dim=1)
    batch.step["centres_differ"] = int((~same_centres).sum())
    bad = clear & differ & same_centres
    bad |= _search_off(batch, labels, cfg)
    return err.cpu().numpy(), (int(bad.sum()) if control is None else 0)


def _search_off(batch, labels, cfg) -> torch.Tensor:
    """Clouds whose loss weights, success flag or answer break the exact
    rules (every cloud where the attack took another number of binary
    steps)."""
    weights, ends = batch.step["weights"], batch.step["ends"]
    fin, res = batch.step["final"], batch.result
    if len(weights) != cfg["binary_step"] or len(ends) != len(weights):
        return torch.ones_like(labels, dtype=torch.bool)
    lower = torch.zeros_like(weights[0])
    upper = torch.full_like(weights[0], cfg["max_weight"])
    want = torch.full_like(weights[0], cfg["init_weight"])
    bad = torch.zeros_like(labels, dtype=torch.bool)
    for got, (score, dist, o_dist) in zip(weights, ends):
        bad |= (got - want).abs() > 1e-6 * want.abs()
        found = (score.long() != labels) & (score != -1) & (dist <= o_dist)
        lower, upper, want = H.search(found, lower, upper, want)
    holds = fin.o_best.score != -1
    bad |= (res.success != holds) | (holds != (lower > 0))
    answer = torch.where(holds[:, None, None], fin.o_best.adv, fin.last)
    bad |= ~(res.adv_points == answer).all(dim=2).all(dim=1)
    return bad
