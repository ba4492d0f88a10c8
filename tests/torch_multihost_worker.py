"""One "host" of tests/test_torch_multihost.py — NOT a test module.

Usage: python torch_multihost_worker.py <host> <hosts> <ranks per host>
       <rendezvous file> <out dir> <mode>

Starts this host's ranks through `hitadv_torch.parallel.spawn` with the
rendezvous file every host names (gloo on the CPU: the stand-in for a
pod of several machines), as the global ranks ``host * ranks + local``.
Each host loads only its own rows of ``synthetic_clouds(16, 64,
seed=77)`` and passes them to the sharded attacks, as the JAX package's
`tests/multihost_worker.py` does. Mode ``attacks`` runs IFGSM and
HiT-ADV; mode ``divisible`` passes 3 rows a host, which no group of four
ranks divides. A host's ranks after its first draw its rows in reverse
order, as a threaded loader may draw them in another order on each rank:
`put_batch` gives every rank of the host its first rank's shard. Each
rank pickles what it got to ``<out dir>/rank<r>.pkl``.
It imports torch and the port only.
"""

import os
import pickle
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
B, N = 16, 64
IFGSM = dict(budget=0.1, num_iter=4)
HIT_ADV = dict(binary_step=2, num_iter=4, central_num=8, total_central_num=12,
               curv_loss_knn=4)


def victim():
    from hitadv_torch.models import PointNet

    return PointNet(40, device="cpu",
                    generator=torch.Generator().manual_seed(0))


def attacks(model):
    """name -> (the attack, the channels it takes, its generator's seed)."""
    from hitadv_torch import attacks as A

    return {
        "ifgsm": (A.make_ifgsm(model, A.make_adv_fn("cross_entropy"),
                               A.FGMConfig(**IFGSM), device="cpu"), 3, 3),
        "hit_adv": (A.make_hit_adv(model, A.make_adv_fn("logits", 30.0,
                                                        False),
                                   A.HiTADVConfig(**HIT_ADV), device="cpu"),
                    6, 5)}


def whole_batch():
    from hitadv_torch.data import synthetic_clouds

    pts, labels = synthetic_clouds(B, N, seed=77)
    return torch.from_numpy(pts), torch.from_numpy(labels).long()


def rank_main(rank: int, out_dir: str, mode: str) -> None:
    from hitadv_torch.parallel import hosts, make_mesh, put_batch, shard_attack

    torch.set_num_threads(1)
    group = make_mesh()
    n_hosts, host = hosts()
    world = torch.distributed.get_world_size()
    pts, labels = whole_batch()
    per = 3 if mode == "divisible" else B // n_hosts
    rows = slice(host * per, (host + 1) * per)
    # this host's loader: only its rows, in reverse order on every rank
    # but the host's first
    drawn = [t[rows].flip(0) if rank % (world // n_hosts) else t[rows]
             for t in (pts, labels)]
    local_pts, local_labels = (put_batch(t, group) for t in drawn)
    out = {"hosts": (n_hosts, host), "world": world,
           "rows": len(local_pts),
           "host_shard": bool(torch.equal(local_pts, pts[rows])
                              and torch.equal(local_labels, labels[rows]))}
    model = victim()
    for name, (attack, channels, seed) in attacks(model).items():
        try:
            res = shard_attack(attack, group)(
                local_pts[..., :channels], local_labels,
                torch.Generator().manual_seed(seed))
        except ValueError as e:
            out[name] = str(e)
            continue
        out[name] = {k: v.numpy() for k, v in res._asdict().items()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def main(argv) -> None:
    from hitadv_torch.parallel import spawn

    host, n_hosts, ranks, rendezvous, out_dir, mode = argv
    spawn(rank_main, int(ranks), (out_dir, mode), backend="gloo",
          init_method=f"file://{rendezvous}", n_hosts=int(n_hosts),
          host=int(host))


if __name__ == "__main__":
    # the ranks unpickle `rank_main` by this module's name
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import torch_multihost_worker as W

    W.main(sys.argv[1:])
