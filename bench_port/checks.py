"""The comparison that decides ``correct``: what the window produced
against the plain reference (`bench_port.reference`), after the window.

Three numbers, each with a limit in ``limits/<cell>.json``:

* ``judge_gap``: the judging. Per judged cloud (clean and adversarial,
  every batch of the window) the largest gap of the program's logits to
  the reference's over the reference's largest logit, reduced over the
  clouds by the limit's statistic; and for each metric of the metric
  pass (kNN, uniformity and curvature-std distance, the window's means)
  its relative gap to the reference's. The number is the largest of
  these.
* ``step_gap``: one attack iteration of a batch drawn from the seed,
  taken again by the reference from the program's state (the step
  module of the traffic), its per-cloud errors reduced by the limit's
  statistic.
* ``exact_off``: what has to hold exactly: how many of the
  evaluation's four counts (clean correct, attack success rate,
  adversarial accuracy, total) differ from a recount over the judge's
  own logits, plus the clouds of the checked batch that break the step
  module's exact rules (the answer is the attack's last state, and so
  on); limit 0.

With ``control`` (a context manager switching TF32 on), the reference
under it stands in for the program in the first two: the control that
has to come out as not correct.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from bench_port.reference import metrics as RM
from bench_port.reference.losses import logits_in_blocks


@contextlib.contextmanager
def tf32():
    """Matrix products and convolutions in TF32, the precision below the
    configuration's float32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def reduce(values: np.ndarray, stat: str) -> float:
    """``"max"`` or ``"q<p>"``, the p-quantile (numpy's linear rule)."""
    if values.size == 0:
        return float("nan")
    if stat == "max":
        return float(np.max(values))
    return float(np.quantile(values, float(stat[1:])))


def failed_clouds(run, traffic: dict) -> int:
    """Clouds with no valid result: not finite, or moved past the
    budget in some coordinate."""
    budget = traffic["attack"]["budget"]
    bad = 0
    for b in run.batches:
        adv, ori = b.result.adv_points, b.points[..., :3]
        ok = torch.isfinite(adv).all(dim=2).all(dim=1)
        ok &= (adv - ori).abs().amax(dim=(1, 2)) <= budget * (1 + 1e-5) \
            + 1e-5
        bad += int((~ok).sum())
    return bad


def _reference(cell):
    from bench_port.harness import load_module, HERE

    return load_module(HERE / "reference" / f"{cell.config['family']}.py")


def judge_errors(run, params, block: int, control=None) -> np.ndarray:
    fwd = _reference(run.cell).forward
    errs = []
    for b in run.batches:
        clouds = (b.points[..., :3].contiguous(), b.result.adv_points)
        for x, got in zip(clouds, b.judged):
            ref = logits_in_blocks(fwd, params, run.cell.config, x, block)
            if control is not None:
                with control():
                    got = logits_in_blocks(fwd, params, run.cell.config, x,
                                           block)
            scale = torch.clamp_min(ref.abs().amax(dim=-1), 1e-30)
            errs.append(((got.float() - ref).abs().amax(dim=-1) / scale
                         ).cpu().numpy())
    return np.concatenate(errs)


METRICS = ("knn_dist", "uniform_dist", "curv_std_dist")


def _metric_means(run, block: int) -> np.ndarray:
    uk = run.cell.traffic["uniform_k"]
    rows = []
    for b in run.batches:
        ori, adv = b.points[..., :3].contiguous(), b.result.adv_points
        normal = b.points[..., 3:6].contiguous()
        # the uniformity is a mean over the whole batch: blocks of clouds
        # add up to it by their share of the disks
        parts = [RM.batch_metrics(ori[i:i + block], adv[i:i + block],
                                  normal[i:i + block], uk)
                 * (min(block, ori.shape[0] - i) / ori.shape[0])
                 for i in range(0, ori.shape[0], block)]
        rows.append(torch.stack(parts).sum(0))
    return torch.stack(rows).mean(0).cpu().numpy()


def metric_errors(run, block: int, control=None) -> np.ndarray:
    ref = _metric_means(run, block)
    if control is not None:
        with control():
            got = _metric_means(run, block)
    else:
        got = np.array([run.eval_metrics[m] for m in METRICS])
    return np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)


def counts_off(run) -> int:
    tot = dict(clean_correct=0, flipped=0, adv_correct=0, total=0)
    for b in run.batches:
        c = RM.counts(torch.argmax(b.judged[0], -1),
                      torch.argmax(b.judged[1], -1), b.labels.long())
        for k in tot:
            tot[k] += c[k]
    m = run.eval_metrics
    mine = (float(tot["clean_correct"]),
            tot["flipped"] / (tot["clean_correct"] + 1e-9),
            tot["adv_correct"] / max(tot["total"], 1.0),
            float(tot["total"]))
    theirs = (m["clean_correct"], m["asr"], m["adv_accuracy"], m["total"])
    return sum(int(a != b) for a, b in zip(mine, theirs))


def checked_batch(run) -> int:
    """The batch whose step is taken again: drawn from the seed among the
    window's batches."""
    rng = np.random.default_rng([run.seed, 11])
    return int(rng.integers(0, len(run.batches)))


def step_errors(run, params, block: int, control=None):
    """(per-cloud errors, clouds off the exact rules) of the checked
    batch's step."""
    from bench_port.harness import step_module

    cell = run.cell
    mod = step_module(cell.traffic["step_check"])
    batch = run.batches[checked_batch(run)]
    return mod.readings(batch, cell, params, _reference(cell).forward,
                        block, run.seed, control=control)


def readings(run, params, block: int = 32, control=None) -> dict:
    """The numbers of ``run``: ``{"numbers": {name: value}, "detail":
    ...}`` with every per-cloud error kept for calibration."""
    limits = run.cell.limits
    judge = judge_errors(run, params, block, control)
    metric = metric_errors(run, block, control)
    step, step_off = step_errors(run, params, block, control)
    numbers = {
        "judge_gap": max(reduce(judge, limits.get("judge_gap", {}).get(
            "stat", "max")), float(np.max(metric))),
        "step_gap": reduce(step, limits.get("step_gap", {}).get(
            "stat", "max")),
    }
    if control is None:
        numbers["exact_off"] = float(counts_off(run) + step_off)
    return {"numbers": numbers,
            "detail": {"judge": judge, "metric": metric, "step": step}}


def verdict(numbers: dict, limits: dict) -> Optional[list]:
    """``[(name, value, limit, ok)]`` for every number; a number without a
    limit is not correct."""
    out = []
    for name, value in numbers.items():
        lim = limits.get(name, {}).get("limit")
        ok = lim is not None and np.isfinite(value) and value <= lim
        out.append((name, value, lim, bool(ok)))
    return out
