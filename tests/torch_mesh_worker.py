"""The ranks of tests/test_torch_parallel.py — NOT a test module.

`checks` runs as each rank of a 2-rank gloo group on the CPU, started by
`hitadv_torch.parallel.spawn`: it runs the sharded attacks, the ring set
distances, the restarts over the ranks and `hitadv_torch.eval.main`
with ``--n_devices 2`` and ``--sp_devices 2`` in the group, and rank 0
runs each one's single-process counterpart too. Each rank pickles its
results (numpy arrays) to ``<out_dir>/rank<r>.pkl`` for the test module
to compare. It imports torch and the port only.
"""

import os
import pickle

import numpy as np
import torch

B, N, CLASSES = 8, 64, 10
PKL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "asr_victim_params.pkl")


def _np(res):
    return {k: v.detach().cpu().numpy() for k, v in res._asdict().items()}


def attack_makers(model):
    """name -> a function making a fresh attack (Add-Object keeps one
    RandomState across its batches, so each run takes a new one)."""
    from hitadv_torch import attacks as A

    ce = A.make_adv_fn("cross_entropy")
    margin = A.make_adv_fn("logits", 30.0, targeted=False)
    targeted = A.make_adv_fn("logits", 30.0, targeted=True)
    fgm = A.FGMConfig(budget=0.1, num_iter=4)
    return {
        "ifgsm": lambda: A.make_ifgsm(model, ce, fgm, device="cpu"),
        "pgd": lambda: A.make_pgd(model, ce, fgm, device="cpu"),
        "hit_adv": lambda: A.make_hit_adv(
            model, margin, A.HiTADVConfig(
                binary_step=2, num_iter=4, central_num=8,
                total_central_num=16, curv_loss_knn=4), device="cpu"),
        "add_cluster": lambda: A.make_cw_add_clusters(
            model, targeted, cfg=A.AddClusterConfig(
                binary_step=1, num_iter=2, num_add=2, cl_num_p=8,
                num_cri=16), device="cpu"),
        "add_object": lambda: A.make_cw_add_objects(
            model, targeted, cfg=A.AddObjectConfig(
                binary_step=1, num_iter=2, num_add=2, obj_num_p=8,
                num_cri=16), device="cpu"),
    }


def batches():
    """Two batches of B synthetic clouds with normals (seeds 20 and 21)."""
    from hitadv_torch.data import synthetic_clouds

    out = []
    for seed in (20, 21):
        pts, labels = synthetic_clouds(B, N, num_classes=CLASSES, seed=seed)
        out.append((torch.from_numpy(pts), torch.from_numpy(labels).long()))
    return out


def ring_inputs():
    rng = np.random.RandomState(7)
    return (torch.from_numpy(rng.randn(2, N, 3).astype(np.float32)),
            torch.from_numpy(rng.randn(2, N, 3).astype(np.float32)))


MAIN_ARGV = ["--dataset", "synthetic", "--batch_size", "8",
             "--synthetic_size", "16", "--num_point", "64", "--num_class",
             "10", "--device", "cpu", "--log_dir", ""]
HIT_ARGV = ["--attack_type", "hit-adv", "--binary_step", "2", "--num_iter",
            "4", "--central_num", "8", "--total_central_num", "16",
            "--curv_loss_knn", "4"]
RING_ARGV = ["--attack_type", "cw-perturb", "--dist_func", "chamfer",
             "--binary_step", "2", "--num_iter", "4"]


def checks(rank: int, out_dir: str) -> None:
    from hitadv_torch import eval as EV
    from hitadv_torch.models import PointNet
    from hitadv_torch.parallel import (
        make_mesh,
        population_attack,
        ring_chamfer,
        ring_hausdorff,
        shard_attack,
    )

    torch.set_num_threads(2)
    group = make_mesh()
    lead = rank == 0
    out = {}
    model = PointNet(CLASSES, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    data = batches()
    for name, make in attack_makers(model).items():
        sharded = shard_attack(make(), group)
        for b, (pts, labels) in enumerate(data):
            gen = torch.Generator().manual_seed(100 + b)
            out[f"{name}/{b}/sharded"] = _np(sharded(pts, labels, gen))
        if lead:
            single = make()
            for b, (pts, labels) in enumerate(data):
                gen = torch.Generator().manual_seed(100 + b)
                out[f"{name}/{b}/single"] = _np(single(pts, labels, gen))

    pts, labels = data[0]
    try:
        shard_attack(attack_makers(model)["ifgsm"](), group)(
            pts[:7], labels[:7], torch.Generator().manual_seed(0))
    except ValueError as e:
        out["not_divisible"] = str(e)

    pgd = attack_makers(model)["pgd"]()
    out["population/group"] = _np(population_attack(pgd, 4, group)(
        pts, labels, torch.Generator().manual_seed(5)))
    if lead:
        out["population/single"] = _np(population_attack(pgd, 4)(
            pts, labels, torch.Generator().manual_seed(5)))

    adv0, ori = ring_inputs()
    for fn_name, fn in (("chamfer", ring_chamfer),
                        ("hausdorff", ring_hausdorff)):
        for method in ("adv2ori", "ori2adv", "both"):
            adv = adv0.clone().requires_grad_(True)
            value = fn(adv, ori, group, method)
            (grad,) = torch.autograd.grad(value.sum(), adv)
            out[f"ring/{fn_name}/{method}"] = (value.detach().numpy(),
                                               grad.numpy())

    out["main/n_devices"] = EV.main(MAIN_ARGV + HIT_ARGV
                                    + ["--n_devices", "2"])
    out["main/sp_devices"] = EV.main(MAIN_ARGV + RING_ARGV
                                     + ["--sp_devices", "2"])
    if lead:
        out["main/single_hit"] = EV.main(MAIN_ARGV + HIT_ARGV)
        out["main/single_ring"] = EV.main(MAIN_ARGV + RING_ARGV)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
