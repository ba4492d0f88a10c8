"""The port's multi-host launch on the CPU: two processes as two hosts.

Mirrors `tests/test_multihost.py`. Each host runs
`tests/torch_multihost_worker.py`, which starts its ranks through
`hitadv_torch.parallel.spawn` with a rendezvous file in ``tmp_path`` (no
port is taken, so xdist's workers do not collide) and the host count and
index; each host feeds only its own rows of the batch. Both hosts must
get the same global result, equal to one process running the attack on
the whole batch.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_multihost_worker as W
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_parallel import SHARD_ATOL

HERE = os.path.dirname(os.path.abspath(__file__))


def _run_hosts(tmp_path, ranks, mode):
    """Start the two hosts, wait for them (300 s each at most) and return
    every rank's pickled results in global rank order."""
    rendezvous = tmp_path / "rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"),
         str(host), "2", str(ranks), str(rendezvous), str(tmp_path), mode],
        cwd=os.path.dirname(HERE), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for host in range(2)]
    for p in procs:
        try:
            log, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
        assert p.returncode == 0, f"host failed:\n{log[-3000:]}"
    return [pickle.load(open(tmp_path / f"rank{r}.pkl", "rb"))
            for r in range(2 * ranks)]


@pytest.fixture(scope="module")
def single():
    """One process attacking the whole batch."""
    pts, labels = W.whole_batch()
    out = {}
    for name, (attack, channels, seed) in W.attacks(W.victim()).items():
        res = attack(pts[..., :channels], labels,
                     torch.Generator().manual_seed(seed))
        out[name] = {k: v.numpy() for k, v in res._asdict().items()}
    return out


def _check_hosts(ranks, per_host, single):
    """Every rank holds its host's first rank's shard of 8 rows and the
    same global result, one process's on the 16 within `SHARD_ATOL`
    (HiT-ADV's whole-batch min and max and its batch draws cross the
    hosts)."""
    for r, got in enumerate(ranks):
        assert got["hosts"] == (2, r // per_host)
        assert got["world"] == 2 * per_host
        assert got["rows"] == 8 and got["host_shard"]
    for name, want in single.items():
        a = ranks[0][name]
        for got in ranks[1:]:
            for key in want:
                np.testing.assert_array_equal(a[key], got[name][key])
        np.testing.assert_array_equal(a["success"], want["success"])
        np.testing.assert_array_equal(a["pred"], want["pred"])
        assert a["adv_points"].shape == want["adv_points"].shape
        np.testing.assert_allclose(a["adv_points"], want["adv_points"],
                                   atol=SHARD_ATOL, rtol=0)


@pytest.mark.parametrize("per_host", [1, 2])
def test_two_hosts_match_one_process(tmp_path, single, per_host):
    """IFGSM and HiT-ADV sharded over two hosts of one rank or two each,
    each host feeding its 8 rows, a host's second rank drawing them in
    another order: every rank attacks its rows of its host's first
    rank's shard, and all hold one process's result."""
    _check_hosts(_run_hosts(tmp_path, per_host, "attacks"), per_host,
                 single)


def test_global_batch_not_divisible_over_the_ranks(tmp_path):
    """Two hosts of two ranks, each host passing 3 rows: the global batch
    of 6 does not divide over the four ranks, and every rank raises JAX's
    message."""
    for r, got in enumerate(_run_hosts(tmp_path, 2, "divisible")):
        assert got["hosts"] == (2, r // 2) and got["world"] == 4
        assert got["rows"] == 3 and got["host_shard"]
        for name in ("ifgsm", "hit_adv"):
            assert got[name].startswith(
                "shard_attack: global batch 6 is not divisible by the "
                "4-device mesh")
