"""The port's defenses (`hitadv_torch.defense`) against
`hitadv_tpu.defense` on the CPU.

SRS and the jitter get the JAX package's draws pinned (its permutations
of ``fold_in(key, N)``, its normal draw of ``key``). SOR's kNN takes
matmul distances in the JAX XLA path and the elementwise form in the
port, so the test asserts first that the indices agree on its clouds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu import defense as JDF
from hitadv_tpu.models import pointnet as JP
from hitadv_tpu.ops import geometry as JG
from hitadv_torch import defense as DF
from hitadv_torch.convert import params_from_numpy
from hitadv_torch.models import PointNet
from hitadv_torch.ops import geometry as G
from test_torch_kernels import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def xla_backend():
    prev = JG.get_backend()
    JG.set_backend("xla")
    try:
        yield
    finally:
        JG.set_backend(prev)


def _cloud(seed, B=2, N=96):
    pc = np.random.RandomState(seed).rand(B, N, 3).astype(np.float32)
    pc[:, :3] *= 4.0                          # a few outliers
    return pc


@pytest.mark.parametrize("drop_num,N", [(30, 96), (96, 96), (200, 96)])
def test_srs_with_pinned_permutations(drop_num, N):
    pc = _cloud(0, N=N)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JDF.make_srs(drop_num, key)(jnp.asarray(pc)))
    keys = jax.random.split(jax.random.fold_in(key, N), 2)
    perms = np.array(jax.vmap(lambda k: jax.random.permutation(k, N))(keys))
    srs = DF.make_srs(drop_num, permutations=perms)
    got = srs(torch.from_numpy(pc))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(srs(torch.from_numpy(pc)), got)      # fixed
    keep = max(N - drop_num, 1)
    assert len({tuple(p) for p in got.numpy()[0]}) == keep
    with pytest.raises(ValueError, match="permutations"):
        srs(torch.from_numpy(pc[:, :50].copy()))


def test_srs_and_jitter_draw_once_per_shape():
    """A seeded defense is a fixed function of its input's shape: the
    same output on every call, the same from the same seed."""
    pc = torch.from_numpy(_cloud(1))
    for make in (lambda g: DF.make_srs(30, g),
                 lambda g: DF.make_jitter(generator=g)):
        a = make(torch.Generator().manual_seed(5))
        b = make(torch.Generator().manual_seed(5))
        out = a(pc)
        assert torch.equal(a(pc), out) and torch.equal(b(pc), out)
        assert not torch.equal(out, pc)
        assert a(pc[:, :40].contiguous()).shape == (2, 40, 3)


def test_sor_matches_jax():
    pc = _cloud(2)
    _, want_idx = JG.knn_indices(jnp.asarray(pc), 2)
    _, idx = G.knn_indices(torch.from_numpy(pc), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    want = np.asarray(JDF.make_sor()(jnp.asarray(pc)))
    got = DF.make_sor()(torch.from_numpy(pc)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != pc).any(axis=-1).sum() >= 2          # outliers snapped


def test_jitter_with_pinned_noise():
    pc = _cloud(3)
    key = jax.random.PRNGKey(7)
    want = np.asarray(JDF.make_jitter(0.02, 0.03, key)(jnp.asarray(pc)))
    noise = np.array(jax.random.normal(key, pc.shape))
    got = DF.make_jitter(0.02, 0.03, noise=noise)(torch.from_numpy(pc))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(got.numpy() - pc).max() <= 0.03 + 1e-7


def test_get_defense():
    for name in (None, "", "none", "NULL"):
        assert DF.get_defense(name, device="cpu") is None
    with pytest.raises(ValueError, match="unknown defense"):
        DF.get_defense("nope", device="cpu")
    pc = torch.from_numpy(_cloud(4))
    for name in ("srs", "SOR", "jitter"):
        out = DF.get_defense(name, device="cpu")(pc)
        assert out.shape == pc.shape and torch.isfinite(out).all()
    f = lambda x: x.sum()                                   # noqa: E731
    assert DF.defended_logits_fn(f, None) is f


def test_gradient_through_sor_matches_jax():
    tree = jax.tree_util.tree_map(np.asarray, JP.init(jax.random.PRNGKey(1)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = PointNet(params=params_from_numpy(tree, "cpu"), device="cpu")
    pc = _cloud(5, N=128) - 0.5
    w = np.random.RandomState(6).randn(2, 40).astype(np.float32)
    jf = JDF.defended_logits_fn(lambda x: JP.apply(params, x),
                                JDF.make_sor())
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(jf(x) * w))(
        jnp.asarray(pc)))
    x = torch.tensor(pc, requires_grad=True)
    lg = DF.defended_logits_fn(model, DF.make_sor())(x)
    (lg * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(lg.detach().numpy(),
                               np.asarray(jf(jnp.asarray(pc))), rtol=1e-4,
                               atol=1e-5)
    # f32 products in other orders through PointNet (~1e-6 relative)
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=1e-3,
                               atol=1e-3 * np.abs(want_g).max())
    assert (DF.make_sor()(torch.from_numpy(pc)).numpy() != pc).any()
