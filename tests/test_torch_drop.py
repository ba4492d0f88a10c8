"""The port's SaliencyDrop (`hitadv_torch.attacks.drop`) against
`hitadv_tpu.attacks.drop` on the CPU, on one PointNet parameter tree.

Each round drops the k most salient points; two saliencies within f32
rounding of each other could fall on either side of the cut in the two
packages. The test records the port's saliency each round and asserts
first that the gap at every cut (between the last point dropped and the
first kept) stands above ``GAP`` of the round's largest |saliency|, far
above the ~1e-6 relative rounding of the two packages' gradients; on
such clouds the survivors must be the same points.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu.attacks import drop as JD
from hitadv_tpu.data import synthetic_clouds
from hitadv_tpu.models import pointnet as JP
from hitadv_tpu.ops import geometry as JG
from hitadv_torch.attacks import drop as D
from hitadv_torch.convert import params_from_numpy
from hitadv_torch.models import PointNet
from test_torch_kernels import one_torch_thread  # noqa: F401

GAP = 1e-4
CFG = dict(num_drop=22, k=5)                 # 5 rounds, the last partial


@pytest.fixture(autouse=True)
def xla_backend():
    prev = JG.get_backend()
    JG.set_backend("xla")
    try:
        yield
    finally:
        JG.set_backend(prev)


@pytest.fixture(scope="module")
def victims():
    tree = jax.tree_util.tree_map(np.asarray, JP.init(jax.random.PRNGKey(42)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = PointNet(params=params_from_numpy(tree, "cpu"), device="cpu")
    return jax.jit(lambda x: JP.apply(params, x)), model


def test_saliency_drop_survivors_match_jax(victims, monkeypatch):
    jfn, model = victims
    pts, labels = synthetic_clouds(2, 96, seed=11)
    scores = []
    real = D._score

    def recording(*a):
        scores.append(real(*a))
        return scores[-1]

    monkeypatch.setattr(D, "_score", recording)
    got = D.make_saliency_drop(model, D.DropConfig(**CFG), device="cpu")(
        pts, labels)
    want = JD.make_saliency_drop(jfn, JD.DropConfig(**CFG))(
        jnp.asarray(pts), jnp.asarray(labels))
    assert len(scores) == 5
    dropped = np.zeros((2, 96), bool)
    for i, s in enumerate(scores):
        s = s.numpy()
        k = min(CFG["k"], CFG["num_drop"] - i * CFG["k"])
        live = np.sort(np.where(dropped, -np.inf, s), axis=1)[:, ::-1]
        top = np.abs(s).max(axis=1)
        assert ((live[:, k - 1] - live[:, k]) > GAP * top).all(), (
            f"round {i}: a near tie at the cut; pick other clouds")
        dropped[np.arange(2)[:, None],
                np.argsort(-np.where(dropped, -np.inf, s), axis=1,
                           kind="stable")[:, :k]] = True
    adv = got.adv_points.numpy()
    assert adv.shape == (2, 96 - 22, 3)
    np.testing.assert_array_equal(adv, np.asarray(want.adv_points))
    # the survivors are clean points, in their original order
    for b in range(2):
        rows = [np.flatnonzero((pts[b, :, :3] == p).all(-1))[0]
                for p in adv[b]]
        assert rows == sorted(rows) and len(set(rows)) == len(rows)
        assert sorted(set(range(96)) - set(rows)) == \
            sorted(np.flatnonzero(dropped[b]))
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))


def test_dead_copies_gradient_goes_back_to_the_survivor(victims,
                                                       monkeypatch):
    """The static-shape rounds see the shrunk cloud's gradient: after a
    round that drops point 0, the first survivor's dead copies (point 0
    among them, before it) take the max-pool's gradient, and the attack
    hands it back, so every survivor's gradient equals the one of the
    cloud with the dead points removed."""
    _, model = victims
    pts, labels = synthetic_clouds(1, 96, seed=12)  # drops point 0 first
    seen = []
    real = D._score

    def recording(pc, grad, center):
        seen.append((pc, grad))
        return real(pc, grad, center)

    monkeypatch.setattr(D, "_score", recording)
    D.make_saliency_drop(model, D.DropConfig(num_drop=10, k=5),
                         device="cpu")(pts, labels)
    pc, grad = seen[1]                      # after the first round
    x = torch.from_numpy(pts[..., :3].copy())
    alive = (pc == x).all(-1)[0]
    assert not alive[0] and int(alive.sum()) == 91
    shrunk = x[:, alive].clone().requires_grad_(True)
    loss = torch.mean(D.cross_entropy_loss(model(shrunk),
                                           torch.from_numpy(labels).long()))
    (want,) = torch.autograd.grad(loss, shrunk)
    torch.testing.assert_close(grad[:, alive], want, rtol=1e-4, atol=1e-7)


def test_sat_forward_matches_jax(victims):
    jfn, model = victims
    pts, labels = synthetic_clouds(2, 96, seed=12)
    cfg = dict(num_drop=20, k=5)
    got = D.make_sat_forward(model, 0.05, D.DropConfig(**cfg),
                             device="cpu")(pts, labels)
    want = JD.make_sat_forward(jfn, 0.05, JD.DropConfig(**cfg))(
        jnp.asarray(pts), jnp.asarray(labels))
    # the cut between the 20 perturbed and the 76 kept: decided
    sal = D._saliency(model, torch.from_numpy(pts[..., :3].copy()),
                      torch.from_numpy(labels).long()).numpy()
    srt = np.sort(sal, axis=1)[:, ::-1]
    assert ((srt[:, 19] - srt[:, 20]) > GAP * np.abs(sal).max(1)).all()
    (adv, dele), (jadv, jdel) = got, want
    assert adv.shape == (2, 96, 3) and dele.shape == (2, 76, 3)
    # the perturbed points moved by the same signs (f32 sums of a step
    # and a coordinate); the kept ones copied, in ascending saliency
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), atol=1e-6)
    np.testing.assert_array_equal(dele.numpy(), np.asarray(jdel))
