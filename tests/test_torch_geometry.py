"""The port's geometry against `hitadv_tpu.ops.geometry` (XLA backend).

Inputs come from numpy seeds and go to both packages; the port runs on
the CPU, where its kernels take their plain versions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu.ops import geometry as JG
from hitadv_torch.ops import geometry as G


@pytest.fixture(autouse=True)
def xla_backend():
    """The JAX side on its plain XLA path; the knob is restored after."""
    prev = JG.get_backend()
    JG.set_backend("xla")
    try:
        yield
    finally:
        JG.set_backend(prev)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _cloud(seed, B, N, C=3):
    return np.random.RandomState(seed).randn(B, N, C).astype(np.float32)


def test_square_distance():
    a, b = _cloud(0, 2, 100, 3), _cloud(1, 2, 130, 3)
    want = np.asarray(JG.square_distance(jnp.asarray(a), jnp.asarray(b)))
    got = G.square_distance(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_index_points_value_and_grad():
    x = _cloud(2, 2, 100, 4)
    idx = np.random.RandomState(3).randint(0, 100, (2, 30, 5)).astype(np.int32)
    wgt = np.random.RandomState(4).randn(2, 30, 5, 4).astype(np.float32)
    want = np.asarray(JG.index_points(jnp.asarray(x), jnp.asarray(idx)))
    want_g = np.asarray(jax.grad(lambda p: jnp.sum(
        JG.index_points(p, jnp.asarray(idx)) * wgt))(jnp.asarray(x)))
    xt = _t(x, grad=True)
    got = G.index_points(xt, _t(idx))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (got * _t(wgt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("Nq,N,k", [(100, 130, 8), (130, 130, 5)])
def test_knn_points_values_and_grads(Nq, N, k):
    q, p = _cloud(5, 2, Nq), _cloud(6, 2, N)
    wgt = np.random.RandomState(7).randn(2, Nq, k).astype(np.float32)
    want = JG.knn_points(jnp.asarray(q), jnp.asarray(p), k)

    def jloss(q, p):
        return jnp.sum(JG.knn_points(q, p, k).dists * wgt)

    want_gq, want_gp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q),
                                                      jnp.asarray(p))
    qt, pt = _t(q, grad=True), _t(p, grad=True)
    got = G.knn_points(qt, pt, k)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    # the reference's XLA path takes the matmul distance form; the port
    # the kernel's elementwise form: f32 rounding apart
    np.testing.assert_allclose(got.dists.detach().numpy(),
                               np.asarray(want.dists), rtol=1e-4, atol=1e-5)
    (got.dists * _t(wgt)).sum().backward()
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(want_gq),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want_gp),
                               rtol=1e-4, atol=1e-4)


def test_knn_indices_drop_self():
    x = _cloud(8, 2, 100)
    wd, wi = JG.knn_indices(jnp.asarray(x), 6)
    gd, gi = G.knn_indices(_t(x), 6)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("N,npoint,start", [(130, 32, 0), (100, 40, 17)])
def test_farthest_point_sample_fixed_start(N, npoint, start):
    x = _cloud(9, 2, N)
    want = JG.farthest_point_sample(jnp.asarray(x), npoint, start_idx=start)
    got = G.farthest_point_sample(_t(x), npoint, start_idx=start)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_farthest_point_sample_generator_start_is_seeded():
    x = _t(_cloud(10, 3, 100))
    a = G.farthest_point_sample(x, 16, generator=torch.Generator()
                                .manual_seed(3))
    b = G.farthest_point_sample(x, 16, generator=torch.Generator()
                                .manual_seed(3))
    assert torch.equal(a, b)
    assert a.dtype == torch.int32 and a.shape == (3, 16)


def test_median_points_even_n_is_lower_median():
    x = _cloud(11, 2, 100)
    want = np.asarray(JG.median_points(jnp.asarray(x), axis=1))
    got = G.median_points(_t(x), dim=1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x, axis=1)[:, 49])


def test_gaussian_blend_values_and_grads():
    rng = np.random.RandomState(12)
    B, Cn, N = 2, 12, 100
    ori = _cloud(13, B, N)
    central = ori[:, rng.choice(N, Cn, replace=False)]   # on the cloud
    delta = (0.1 + 1.1 * rng.rand(B, Cn)).astype(np.float32)
    pert = (0.55 * rng.rand(B, Cn, 3)).astype(np.float32)
    w_num = rng.randn(B, N, 3).astype(np.float32)
    w_den = rng.randn(B, N).astype(np.float32)

    negd_j = JG.neg_gaussian_field(jnp.asarray(central), jnp.asarray(ori))
    negd_t = G.neg_gaussian_field(_t(central), _t(ori))
    np.testing.assert_allclose(negd_t.numpy(), np.asarray(negd_j),
                               rtol=1e-6, atol=1e-7)

    def jloss(d, p):
        num, den = JG.gaussian_blend(jnp.asarray(central), jnp.asarray(ori),
                                     d, p)
        return jnp.sum(num * w_num) + jnp.sum(den * w_den), (num, den)

    (_, (jn, jd)), (jgd, jgp) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(delta),
                                            jnp.asarray(pert))
    dt, pt = _t(delta, grad=True), _t(pert, grad=True)
    num, den = G.gaussian_blend(_t(central), _t(ori), dt, pt, negd=negd_t)
    (torch.sum(num * _t(w_num)) + torch.sum(den * _t(w_den))).backward()
    for got, want in [(num, jn), (den, jd), (dt.grad, jgd), (pt.grad, jgp)]:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    # without the hoisted field the blend builds it itself: same bits
    num2, den2 = G.gaussian_blend(_t(central), _t(ori), _t(delta), _t(pert))
    assert torch.equal(num2, num.detach()) and torch.equal(den2, den.detach())


def test_l2_normalize():
    x = _cloud(14, 2, 50)
    x[0, 0] = 0.0
    np.testing.assert_allclose(G.l2_normalize(_t(x)).numpy(),
                               np.asarray(JG.l2_normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
