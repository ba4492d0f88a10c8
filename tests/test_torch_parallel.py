"""The port's parallel modes (`hitadv_torch.parallel`: `shard_attack`,
`population_attack`, `ring_chamfer`, `ring_hausdorff`, and their flags
in `hitadv_torch.eval`) on the CPU.

The multi-rank checks run once per module in one 2-rank gloo group
(`tests/torch_mesh_worker.py`, started by `hitadv_torch.parallel.spawn`,
whose rendezvous is a file in a temporary directory: no port is taken,
so xdist's workers do not collide); the tests here compare what the
ranks pickled with the single-process runs and with the JAX package's
dense distances.
"""

import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_mesh_worker as W
from hitadv_tpu import losses as JL
from hitadv_torch import eval as EV
from hitadv_torch import losses as L
from hitadv_torch.attacks import AttackResult
from hitadv_torch.config import EvalConfig
from hitadv_torch.parallel import (
    population_attack,
    restart_generators,
    spawn,
)

# sharded against single-process attacks: the loss means are summed per
# rank, then over the ranks, and HiT-ADV's Adam steps carry that rounding
# through its iterations (read: 6e-8 for HiT-ADV, the others bitwise);
# 1e-6 of the unit-sphere coordinates is far below any step (lr 1e-2,
# FGM 0.025)
SHARD_ATOL = 1e-6
# the ring's sums are taken per rank, then over the ranks; each value is
# a mean or max of f32 squared distances ~1, so 1e-6 relative is a few
# ulps; the gradients are sums of a handful of f32 terms each (the dense
# ones' terms, added in another order)
RING_RTOL, RING_ATOL, GRAD_ATOL = 1e-6, 1e-6, 1e-6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' pickled results."""
    out = tmp_path_factory.mktemp("mesh")
    spawn(W.checks, 2, (str(out),), backend="gloo")
    return [pickle.load(open(os.path.join(out, f"rank{r}.pkl"), "rb"))
            for r in range(2)]


@pytest.mark.parametrize("name", ["ifgsm", "pgd", "hit_adv", "add_cluster",
                                  "add_object"])
@pytest.mark.parametrize("batch", [0, 1])
def test_shard_attack_matches_single(ranks, name, batch):
    """Each attack split over the two ranks, on two batches in turn,
    against one process on the whole batch: the same success and
    predictions, clouds within `SHARD_ATOL`, and both ranks hold the same
    gathered result. IFGSM and PGD draw their starts from the batch's
    generator, HiT-ADV its FPS starts and each binary step's pert and
    delta and normalises by the whole batch's min and max; the Add
    attacks seed on the host from the whole batch's critical points
    (Add-Object's RandomState running on across the batches)."""
    got = ranks[0][f"{name}/{batch}/sharded"]
    want = ranks[0][f"{name}/{batch}/single"]
    for key, other in ranks[1][f"{name}/{batch}/sharded"].items():
        np.testing.assert_array_equal(other, got[key])
    np.testing.assert_array_equal(got["success"], want["success"])
    np.testing.assert_array_equal(got["pred"], want["pred"])
    assert got["adv_points"].shape == want["adv_points"].shape
    np.testing.assert_allclose(got["adv_points"], want["adv_points"],
                               atol=SHARD_ATOL, rtol=0)


def test_shard_attack_not_divisible(ranks):
    for r in ranks:
        assert r["not_divisible"].startswith(
            "shard_attack: global batch 7 is not divisible by the "
            "2-device mesh")


def test_population_over_ranks_matches_single(ranks):
    """Four PGD restarts, two on each rank, gathered and selected on
    every rank: the one-process selection bit for bit."""
    want = ranks[0]["population/single"]
    for r in ranks:
        for key, value in r["population/group"].items():
            np.testing.assert_array_equal(value, want[key])


@pytest.mark.parametrize("fn", ["chamfer", "hausdorff"])
@pytest.mark.parametrize("method", ["adv2ori", "ori2adv", "both"])
def test_ring_matches_dense(ranks, fn, method):
    """`ring_chamfer` / `ring_hausdorff` over the two ranks (each holding
    32 of the 64 points, the other's block passed round the ring): the
    values and the gradient with respect to ``adv`` of the dense
    distances, the JAX package's (`losses.chamfer_dist` /
    `hausdorff_dist`) and the port's, within f32 rounding; both ranks
    replicated."""
    adv, ori = W.ring_inputs()
    value, grad = ranks[0][f"ring/{fn}/{method}"]
    for a, b in zip((value, grad), ranks[1][f"ring/{fn}/{method}"]):
        np.testing.assert_array_equal(a, b)
    jfn = {"chamfer": JL.chamfer_dist, "hausdorff": JL.hausdorff_dist}[fn]
    ja, jo = jnp.asarray(adv.numpy()), jnp.asarray(ori.numpy())
    jv = np.asarray(jfn(ja, jo, method))
    jg = np.asarray(jax.grad(lambda a: jfn(a, jo, method).sum())(ja))
    pfn = {"chamfer": L.chamfer_dist, "hausdorff": L.hausdorff_dist}[fn]
    pa = adv.clone().requires_grad_(True)
    pv = pfn(pa, ori, method)
    (pg,) = torch.autograd.grad(pv.sum(), pa)
    for want_v, want_g in ((jv, jg), (pv.detach().numpy(), pg.numpy())):
        np.testing.assert_allclose(value, want_v, rtol=RING_RTOL,
                                   atol=RING_ATOL)
        np.testing.assert_allclose(grad, want_g, rtol=0, atol=GRAD_ATOL)
    assert np.abs(grad).max() > 1e-3


@pytest.mark.parametrize("flag,single", [("n_devices", "single_hit"),
                                         ("sp_devices", "single_ring")])
def test_main_over_ranks_matches_single(ranks, flag, single):
    """`main` with ``--n_devices 2`` (HiT-ADV, each batch split over the
    ranks) and with ``--sp_devices 2`` (CW-Perturb on the ring Chamfer)
    inside the group, against `main` alone: the same counts, the metrics
    within 1e-5 relative (the adversarial clouds within `SHARD_ATOL`)."""
    want = ranks[0][f"main/{single}"]
    for r in ranks:
        got = r[f"main/{flag}"]
        assert got.keys() == want.keys()
        for key in ("asr", "adv_accuracy", "clean_correct", "total"):
            assert got[key] == want[key], key
        for key in ("knn_dist", "uniform_dist", "curv_std_dist"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=key)


def _stub(table):
    """An attack whose restart r (the r-th call) succeeds where
    ``table[r]`` is True, with clouds of value r and prediction 10 + r."""
    calls = []

    def attack(points, labels, generator):
        r = len(calls)
        calls.append(generator)
        B = labels.shape[0]
        return AttackResult(
            adv_points=torch.full((B, 4, 3), float(r)),
            success=torch.tensor(table[r]),
            pred=torch.full((B,), 10 + r, dtype=torch.long))

    return attack, calls


def test_population_selection_on_pinned_successes():
    """Per example the first restart that succeeded (its cloud and
    prediction), restart 0's where none did, success the OR; restart r
    gets the r-th of `restart_generators`."""
    table = [[False, False, True, False, False],
             [False, True, True, False, False],
             [True, True, False, False, False],
             [False, False, False, True, False]]
    attack, calls = _stub(table)
    gen = torch.Generator().manual_seed(3)
    res = population_attack(attack, 4)(torch.zeros(5, 4, 3),
                                       torch.zeros(5, dtype=torch.long), gen)
    first = [2, 1, 0, 3, 0]
    assert res.success.tolist() == [True, True, True, True, False]
    assert res.pred.tolist() == [10 + f for f in first]
    assert res.adv_points[:, 0, 0].tolist() == [float(f) for f in first]
    want = restart_generators(torch.Generator().manual_seed(3), 4)
    assert [g.initial_seed() for g in calls] == \
        [g.initial_seed() for g in want]
    assert len({g.initial_seed() for g in calls}) == 4


def test_restarts_keep_or_and_first_success():
    """The population-wrapped attack that `main` builds for ``--restarts
    4`` (FGSM-RS at budget 0.05 on the trained 10-class victim) keeps,
    per example, the OR of the restarts' successes, and the cloud of the
    first restart that succeeded (each restart run alone with its own
    generator), restart 0's where none did. On these clouds some
    examples fail in every restart and some succeed first in a later
    one."""
    from hitadv_torch.data import synthetic_batches

    cfg = EvalConfig(dataset="synthetic", batch_size=16, num_point=64,
                     num_class=10, checkpoint=W.PKL, attack_type="FGSM_RS",
                     budget=0.05, num_iter=2, restarts=4, device="cpu")
    model = EV.build_model(cfg)
    attack = EV.build_attack(cfg, model, model)
    pts, labels = next(iter(synthetic_batches(1, 16, 64, 10, seed=99)))
    pts, labels = torch.from_numpy(pts), torch.from_numpy(labels).long()
    pop = population_attack(attack, 4)(pts, labels,
                                       torch.Generator().manual_seed(0))
    singles = [attack(pts, labels, g) for g in restart_generators(
        torch.Generator().manual_seed(0), 4)]
    succ = torch.stack([s.success for s in singles])
    assert torch.equal(pop.success, succ.any(0))
    first = torch.argmax(succ.int(), dim=0)
    assert not pop.success.all() and bool((first[pop.success] > 0).any())
    for b in range(16):
        pick = int(first[b]) if pop.success[b] else 0
        assert torch.equal(pop.adv_points[b], singles[pick].adv_points[b])
        assert pop.pred[b] == singles[pick].pred[b]


def test_main_restarts_wraps_population(monkeypatch):
    """``--restarts 4`` through `main` on the CPU: one rank, the attack
    wrapped by `population_attack` with 4 restarts and no group."""
    from hitadv_torch import parallel

    seen = {}
    real = parallel.population_attack

    def spy(attack, restarts, group=None):
        seen["restarts"], seen["group"] = restarts, group
        return real(attack, restarts, group)

    monkeypatch.setattr(parallel, "population_attack", spy)
    m = EV.main(["--dataset", "synthetic", "--batch_size", "8",
                 "--num_point", "64", "--synthetic_size", "8",
                 "--attack_type", "FGSM_RS", "--budget", "0.05",
                 "--num_iter", "2", "--restarts", "4", "--log_dir", "",
                 "--device", "cpu"])
    assert np.isfinite(m["asr"])
    assert seen == {"restarts": 4, "group": None}


def test_restarts_spread_over_the_cards(monkeypatch):
    """``--restarts R`` on the card takes the largest number of the
    machine's CUDA devices that divides R, as the JAX `eval`'s restart
    mesh; one on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for R, n in ((12, 6), (3, 3), (8, 8), (7, 7), (11, 1)):
        assert EV.mesh_size(EvalConfig(restarts=R)) == n
        assert EV.mesh_size(EvalConfig(restarts=R, device="cpu")) == 1


@pytest.mark.parametrize("argv,match", [
    (["--attack_type", "FGSM_RS", "--restarts", "4", "--n_devices", "2"],
     "--restarts shards the restart axis"),
    (["--attack_type", "FGSM_RS", "--restarts", "4", "--sp_devices", "2"],
     "--restarts shards the restart axis"),
    (["--attack_type", "cw-perturb", "--dist_func", "chamfer",
      "--sp_devices", "2", "--n_devices", "2"],
     "--sp_devices \\(points sharded over a ring mesh\\) and --n_devices")])
def test_parallel_flags_exclude_each_other(argv, match):
    """The JAX `eval`'s refusals, with its messages, before any rank
    starts."""
    with pytest.raises(ValueError, match=match):
        EV.main(["--dataset", "synthetic", "--batch_size", "8",
                 "--num_point", "64", "--synthetic_size", "8",
                 "--log_dir", "", "--device", "cpu"] + argv)


def test_ring_needs_a_group():
    cfg = EvalConfig(attack_type="cw-perturb", dist_func="chamfer",
                     sp_devices=2, device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        EV.build_attack(cfg, lambda x: x)


def test_more_ranks_than_cards_raises(monkeypatch):
    """``--n_devices`` past the machine's CUDA devices raises (the JAX
    `eval`'s mesh takes the devices it finds)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="this machine has 1"):
        EV.main(["--dataset", "synthetic", "--n_devices", "2",
                 "--log_dir", ""])
