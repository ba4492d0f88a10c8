"""Attack evaluation: the attack success rate and the imperceptibility
metrics (port of `hitadv_tpu/evaluation.py`; reference
`util/other_utils.py:15-101`, eval_ASR).

Per batch: run the attack, then, on the device and outside autograd, the
kNN outlier distance (k=4), the disk uniformity, the curvature-std
distance (k=4) of the adversarial clouds and the clean and adversarial
predictions. The host reads one small vector of scalars per batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from hitadv_torch import losses as L
from hitadv_torch import resolve_device
from hitadv_torch.utils.logging import timestamped_logger


def _batch_metrics(logits_fn: Callable, ori_xyz: torch.Tensor,
                   adv_xyz: torch.Tensor, ori_normal: torch.Tensor,
                   labels: torch.Tensor, uniform_k: int) -> torch.Tensor:
    """``[knn_dist, uniform_dist, curv_std_dist, asr numerator, asr
    denominator, adversarial correct]`` of one batch as an f64 vector on
    the device (reference `_batch_metrics`)."""
    with torch.no_grad():
        knn_d = torch.mean(L.knn_dist(adv_xyz, k=4))
        uni_d = L.uniform_loss(adv_xyz, k=uniform_k)
        if adv_xyz.shape[1] == ori_xyz.shape[1]:
            curv_d = torch.mean(L.curv_std_dist(ori_xyz, adv_xyz, ori_normal,
                                                k=4))
        else:
            # attacks that drop points: CurvStdDist is undefined across
            # clouds of different sizes, so it is NaN, as in the reference
            curv_d = torch.full((), float("nan"), device=adv_xyz.device)
        mask_ori = torch.argmax(logits_fn(ori_xyz), dim=-1) == labels
        mask_adv = torch.argmax(logits_fn(adv_xyz), dim=-1) == labels
        at_denom = torch.sum(mask_ori)
        at_num = at_denom - torch.sum(mask_ori & mask_adv)
        return torch.stack([t.double() for t in (
            knn_d, uni_d, curv_d, at_num, at_denom, torch.sum(mask_adv))])


def batch_seed(seed: int, batch_index: int) -> int:
    """The seed of batch ``batch_index``'s attack generator: a function of
    the run's seed and the batch alone, so a resumed sweep draws what an
    uninterrupted one would."""
    return int(np.random.SeedSequence([seed, batch_index]).generate_state(1)[0])


def eval_asr(logits_fn: Callable, attack_fn: Callable,
             batches: Iterable[Tuple[np.ndarray, np.ndarray]],
             seed: int = 0, uniform_k: int = 5,
             log_dir: Optional[str] = None, verbose: bool = True,
             progress: Optional[object] = None,
             device="cuda") -> Dict[str, float]:
    """Evaluate the attack success rate over a dataset.

    Args:
      logits_fn: victim, ``[B, N, 3] -> [B, classes]`` on ``device``.
      attack_fn: ``(points [B, N, 3 or 6], labels, generator) ->
        AttackResult``, built for ``device``.
      batches: iterable of ``(points [B, N, 3|6] np, labels [B] np)``.
      seed: each batch's attack draws from a `torch.Generator` on the
        device seeded with `batch_seed(seed, batch index)`.
      uniform_k: k of the uniformity metric (`eval.py` --k, default 5).
      progress: optional `utils.EvalProgress`: resumes a preempted sweep
        (skips completed batches, restores the accumulators, checkpoints
        after each batch).
      device: where the batches go; ``"cuda"`` unless the caller asks for
        the CPU.
    Returns:
      dict with asr, knn_dist, uniform_dist, curv_std_dist, adv_accuracy,
      clean_correct, total.
    """
    dev = resolve_device(device)
    logger = timestamped_logger(log_dir) if log_dir else None
    acc = dict(knn_sum=0.0, uni_sum=0.0, curv_sum=0.0, at_num=0.0,
               at_denom=0.0, adv_correct=0.0, total=0.0, n_batches=0)
    skip_until = 0
    if progress is not None and progress.next_batch > 0:
        acc.update(progress.accumulators())
        skip_until = progress.next_batch

    for batch_index, (points, labels) in enumerate(batches):
        if batch_index < skip_until:
            continue
        points = torch.as_tensor(points, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels).to(dev).long()
        gen = torch.Generator(device=dev).manual_seed(
            batch_seed(seed, batch_index))
        result = attack_fn(points, labels, gen)

        ori_xyz = points[..., :3].contiguous()
        ori_normal = (points[..., 3:6] if points.shape[-1] >= 6
                      else torch.zeros_like(ori_xyz))
        vals = _batch_metrics(logits_fn, ori_xyz, result.adv_points,
                              ori_normal, labels, uniform_k)
        knn_d, uni_d, curv_d, num, denom, correct, succ = torch.cat(
            [vals, result.success.sum().double()[None]]).tolist()

        acc["knn_sum"] += knn_d
        acc["uni_sum"] += uni_d
        acc["curv_sum"] += curv_d
        acc["at_num"] += num
        acc["at_denom"] += denom
        acc["adv_correct"] += correct
        acc["total"] += float(labels.shape[0])
        acc["n_batches"] += 1
        if verbose and logger:
            logger.info(f"batch {acc['n_batches']}: attack success "
                        f"{int(succ)}/{labels.shape[0]}")
        if progress is not None:
            progress.update(batch_index, acc)

    n_batches = max(int(acc["n_batches"]), 1)
    metrics = {
        "asr": acc["at_num"] / (acc["at_denom"] + 1e-9),
        "knn_dist": acc["knn_sum"] / n_batches,
        "uniform_dist": acc["uni_sum"] / n_batches,
        "curv_std_dist": acc["curv_sum"] / n_batches,
        "adv_accuracy": acc["adv_correct"] / max(acc["total"], 1.0),
        "clean_correct": acc["at_denom"],
        "total": acc["total"],
    }
    if logger:
        logger.info(f"Overall attack success rate: {metrics['asr']}")
        logger.info(f"Overall KNN dist: {metrics['knn_dist']}")
        logger.info(f"Overall Uniform dist: {metrics['uniform_dist']}")
        logger.info(f"Overall CurvStd dist: {metrics['curv_std_dist']}")
    return metrics
