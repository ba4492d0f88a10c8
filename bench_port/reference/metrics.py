"""The evaluation's imperceptibility metrics and its success counts, in
plain float32 PyTorch (HiT-ADV's `util/other_utils.py` eval_ASR with the
distances of `util/dist_utils.py` and GeoA3's disk uniformity):

* kNN distance: per point the mean squared distance to its k = 4
  nearest other points; the points above mean + 1.05 std (unbiased)
  count, averaged over the cloud;
* uniformity: FPS of 5% of the points from index 0, five disks of
  0.4%-1.2% (times four) of the points, the k + 1 nearest inside each
  disk, the deviation of their mean spacing from the uniform spacing;
* curvature-std distance: the L2 between the clean and the adversarial
  clouds' fields of the kNN ring's curvature std (k = 4, clean normals).
"""

from __future__ import annotations

import math

import torch

from bench_port.reference import geometry as G

PERCENTAGES = (0.004, 0.006, 0.008, 0.010, 0.012)


def knn_dist(pc: torch.Tensor, k: int = 4, alpha: float = 1.05):
    dists, _ = G.self_knn(pc, k)
    value = torch.mean(dists, dim=-1)
    mean = torch.mean(value, dim=-1, keepdim=True)
    std = torch.std(value, dim=-1, keepdim=True, correction=1)
    mask = (value > mean + alpha * std).to(pc.dtype)
    return torch.mean(value * mask, dim=1)


def uniform(pc: torch.Tensor, k: int) -> torch.Tensor:
    B, n, _ = pc.shape
    npoint = int(n * 0.05)
    start = torch.zeros(B, dtype=torch.long, device=pc.device)
    centres = G.gather(pc, G.fps(pc, npoint, start))
    terms = []
    for pct in PERCENTAGES:
        p = pct * 4
        nsample = int(n * p)
        if nsample < 2:
            continue
        r = math.sqrt(p)
        expect = math.sqrt(math.pi * p / nsample)
        idx = G.ball_query(pc, centres, r, nsample)
        flat = G.gather(pc, idx).reshape(B * npoint, nsample, 3)
        d, _ = G.knn(flat, flat, min(k + 1, nsample))
        ud = torch.mean(torch.sqrt(torch.abs(d[..., 1:]) + 1e-12), dim=-1)
        ud = (ud - expect) ** 2 / (expect + 1e-12)
        terms.append(torch.mean(ud) * (p * 100.0) ** 2)
    return sum(terms) / max(len(terms), 1)


def kappa_std(pc: torch.Tensor, normal: torch.Tensor, k: int):
    _, idx = G.self_knn(pc, k)
    v = G.gather(pc, idx) - pc[:, :, None, :]
    v = v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1,
                                                     keepdim=True), 1e-12)
    kappa = torch.mean(torch.abs(torch.sum(v * normal[:, :, None, :], -1)),
                       dim=-1)
    ring = torch.gather(kappa, 1, idx.reshape(pc.shape[0], -1)
                        ).reshape(idx.shape)
    return torch.std(ring, dim=-1, correction=1), kappa


def curv_std_dist(ori, adv, normal, k: int = 4) -> torch.Tensor:
    return torch.linalg.vector_norm(kappa_std(ori, normal, k)[0]
                                    - kappa_std(adv, normal, k)[0], dim=-1)


def batch_metrics(ori: torch.Tensor, adv: torch.Tensor, normal: torch.Tensor,
                  uniform_k: int) -> torch.Tensor:
    """``[knn_dist, uniform_dist, curv_std_dist]`` of one batch, each the
    batch's mean, as f64."""
    return torch.stack([torch.mean(knn_dist(adv)).double(),
                        uniform(adv, uniform_k).double(),
                        torch.mean(curv_std_dist(ori, adv, normal)).double()])


def counts(clean_pred, adv_pred, labels) -> dict:
    """The success counts of the evaluation from the predictions of a
    batch: clean-correct, flipped among them, adversarially correct, and
    the batch size."""
    ok = clean_pred == labels
    ok_adv = adv_pred == labels
    return {"clean_correct": int(ok.sum()),
            "flipped": int(ok.sum()) - int((ok & ok_adv).sum()),
            "adv_correct": int(ok_adv.sum()),
            "total": int(labels.numel())}
