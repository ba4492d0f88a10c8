"""The port's autoencoder, the AOF family, AdvPC and the LPIPS distance
against `hitadv_tpu`.

Both packages get the same numpy inputs, the same parameter trees (the
JAX package's draws, through `params_from_numpy`) and the same pinned
noise; the port runs on the CPU in f32, the JAX side on its XLA path.
Eigenvectors are fixed only up to sign and to a rotation inside a
degenerate eigenspace, so the bases are compared as projectors ``V V^T``,
each time after asserting a wide gap between the last kept eigenvalue and
the next.

The trajectory comparisons are chaotic at two places, in both packages
alike: a gradient component below Adam's eps (1e-8) steps by lr g / eps,
so the packages' rounding of it (~1e-7 of the largest component) moves
it by a sizeable part of a step; and a success decision at a logit margin
within rounding of 0 keeps another iterate as the best. The clouds of
seed 8 meet neither in 2 x 5 iterations in any mode (seeds 6, 7, 9, 10
and 13 do, in one mode or another), so they are compared at f32 rounding
carried through the steps.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu import losses as JL
from hitadv_tpu.attacks import advpc as JV
from hitadv_tpu.attacks import aof as JO
from hitadv_tpu.attacks import base as JB
from hitadv_tpu.data import synthetic_clouds
from hitadv_tpu.models import autoencoder as JAE
from hitadv_tpu.models import pointnet as JP
from hitadv_tpu.ops import geometry as JG
from hitadv_torch import losses as L
from hitadv_torch.attacks import aof as O
from hitadv_torch.attacks import AdvPCConfig, make_adv_fn, make_advpc
from hitadv_torch.convert import params_from_numpy
from hitadv_torch.models import AutoEncoder, PointNet
from hitadv_torch.models import autoencoder as AE
from hitadv_torch.ops import geometry as G
from test_torch_kernels import one_torch_thread  # noqa: F401

N = 64


@pytest.fixture(autouse=True)
def xla_backend():
    prev = JG.get_backend()
    JG.set_backend("xla")
    try:
        yield
    finally:
        JG.set_backend(prev)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def victims():
    """(JAX logits fn, port model) sharing one random PointNet tree."""
    tree = _np_tree(JP.init(jax.random.PRNGKey(42)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = PointNet(params=params_from_numpy(tree, "cpu"), device="cpu")
    return jax.jit(lambda x: JP.apply(params, x)), model


@pytest.fixture(scope="module")
def ae_tree():
    """A JAX draw of the AE for clouds of N points, latent 128."""
    return _np_tree(JAE.init(jax.random.PRNGKey(7), num_points=N,
                             latent=128))


@pytest.fixture(scope="module")
def aes(ae_tree):
    """(JAX AE fn, port AE) on the same tree."""
    params = jax.tree_util.tree_map(jnp.asarray, ae_tree)
    return (jax.jit(lambda x: JAE.apply(params, x)),
            AutoEncoder(params=params_from_numpy(ae_tree, "cpu"),
                        device="cpu"))


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _cloud(seed, B=2, n=N):
    return synthetic_clouds(B, n, seed=seed)[0][..., :3].copy()


# ---------------------------------------------------------------------------
# The autoencoder
# ---------------------------------------------------------------------------

def test_autoencoder_forward_matches_jax(ae_tree, aes):
    jae, tae = aes
    x = _cloud(0)
    params = jax.tree_util.tree_map(jnp.asarray, ae_tree)
    with torch.no_grad():
        # f32 matmuls in other orders: 1e-5 of values of order 0.1-10
        np.testing.assert_allclose(tae.encode(_t(x)).numpy(), np.asarray(
            JAE.encode(params, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tae(_t(x)).numpy(),
                                   np.asarray(jae(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            tae.reconstruction_loss(_t(x)).item(),
            float(JAE.reconstruction_loss(params, jnp.asarray(x))),
            rtol=1e-5)


def test_autoencoder_parameter_gradient_and_fit_step(ae_tree):
    """The reconstruction loss's gradient to every leaf (the BN
    statistics too) and one `fit` Adam step on a fixed batch."""
    x = _cloud(1, B=3)
    params = jax.tree_util.tree_map(jnp.asarray, ae_tree)
    jgrads = jax.grad(JAE.reconstruction_loss)(params, jnp.asarray(x))
    jstep = jax.tree_util.tree_map(
        lambda g, p: JB.adam_update(g, JB.adam_init(p), p, 1e-3)[0],
        jgrads, params)
    tree = params_from_numpy(ae_tree, "cpu")
    paths, leaves = zip(*AE._leaves(tree))
    xs = [t.clone().requires_grad_(True) for t in leaves]
    loss = AE.reconstruction_loss(AE._unflatten(paths, xs), _t(x))
    tgrads = torch.autograd.grad(loss, xs)
    new, states = AE.fit_step(tree, [AE.adam_init(t) for t in leaves],
                              _t(x), 1e-3)
    for path, g, p in zip(paths, tgrads, AE._leaves(new)):
        jg, jp = jgrads, jstep
        for k in path:
            jg, jp = jg[k], jp[k]
        # f32 sums in other orders, the Chamfer's matmul (JAX) and
        # elementwise (port) distance forms: 1e-4 of the leaf's gradient
        # norm
        jg = np.asarray(jg)
        assert np.linalg.norm(g.numpy() - jg) <= 1e-4 * np.linalg.norm(jg), \
            path
        # Adam's first step is lr g / (|g| + eps), whose derivative in g is
        # at most 1 / (|g| + eps): each element within lr |dg| / (min |g| +
        # eps) of JAX's, plus 1e-7 for the parameter's own rounding
        gt = g.numpy()
        slack = 1e-3 * np.abs(gt - jg) / (np.minimum(np.abs(gt), np.abs(jg))
                                          + 1e-8) + 1e-7
        assert (np.abs(p[1].numpy() - np.asarray(jp)) <= slack).all(), path
    assert states[0].step == 1


def test_fit_draws_batches_from_the_generator(ae_tree):
    tree = params_from_numpy(ae_tree, "cpu")
    clouds = _t(_cloud(2, B=5))
    a = AE.fit(tree, clouds, torch.Generator().manual_seed(3), steps=2,
               batch_size=3)
    b = AE.fit(tree, clouds, torch.Generator().manual_seed(3), steps=2,
               batch_size=3)
    for (_, u), (_, v) in zip(AE._leaves(a), AE._leaves(b)):
        assert torch.equal(u, v)
    loss0 = AE.reconstruction_loss(tree, clouds).item()
    fitted = AE.fit(tree, clouds, torch.Generator().manual_seed(3), steps=20,
                    batch_size=5)
    assert AE.reconstruction_loss(fitted, clouds).item() < loss0


# ---------------------------------------------------------------------------
# Graph Laplacian and its low band
# ---------------------------------------------------------------------------

def _knn_indices_agree(pc, k):
    got = G.knn_idx(_t(pc), _t(pc), k).numpy()
    want = np.asarray(JG.knn_points(jnp.asarray(pc), jnp.asarray(pc), k).idx)
    np.testing.assert_array_equal(got, want)


def test_laplacian_matrix_matches_jax():
    pc = _cloud(3, n=128)
    _knn_indices_agree(pc, 30)
    got = O.laplacian_matrix(_t(pc), 30).numpy()
    want = np.asarray(JO.laplacian_matrix(jnp.asarray(pc), 30))
    np.testing.assert_array_equal(got != 0, want != 0)
    # exp of f32 squared distances from the same matmul form: 1e-6
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _projector(V):
    return V @ np.swapaxes(V, -1, -2)


@pytest.mark.parametrize("lp", [10, 20])
def test_low_band_projector_matches_jax(lp):
    """The projectors onto the ``lp`` lowest eigenvectors agree within a
    bound from the measured eigengap: a perturbation E of L moves the
    projector by about |E| / gap (Davis-Kahan), and the two packages'
    Laplacians and eigensolvers differ by f32 rounding of L's largest
    eigenvalue (a few eps32 lambda_max). The gap must be wide against
    that: 1000 eps32 lambda_max."""
    pc = _cloud(4, n=128)
    _knn_indices_agree(pc, 30)
    e, V = (t.numpy() for t in O.graph_laplacian(_t(pc), 30))
    je, jV = (np.asarray(t) for t in JO.graph_laplacian(jnp.asarray(pc), 30))
    for b in range(2):
        gap = e[b, lp] - e[b, lp - 1]
        lam = e[b, -1]
        eps = np.finfo(np.float32).eps
        # a wide gap: no near-degeneracy at the cut
        assert gap > 1000 * eps * lam, (gap, lam)
        bound = 100 * eps * lam / gap
        d = np.abs(_projector(V[b, :, :lp])
                   - _projector(jV[b, :, :lp])).max()
        assert d <= bound, (d, bound)
        np.testing.assert_allclose(e[b], je[b], atol=10 * np.finfo(
            np.float32).eps * lam)


def _subspace_dist(V1, V2):
    s = np.linalg.svd(V1.T @ V2, compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - s.min() ** 2)))


def test_subspace_solver_converges_in_f64():
    """The partial solver against the full eigh on the same Laplacian in
    f64 at the attack's size (low_pass 100 of N = 1024, k = 30): subspace
    distance below 1e-3, where f64 is not held back by eigh's own f32
    floor (the bound of `test_spectral_ae_attacks.py`)."""
    pc = synthetic_clouds(1, 1024, seed=3)[0][..., :3].copy()
    Lap = O.laplacian_matrix(_t(pc), 30).double()
    _, V = torch.linalg.eigh(Lap)
    _, Vp = O.low_band_subspace(Lap, 100,
                                generator=torch.Generator().manual_seed(0))
    assert _subspace_dist(V[0, :, :100].numpy(), Vp[0].numpy()) < 1e-3


def test_subspace_solver_f32_reaches_the_eigh_floor():
    pc = _cloud(5, n=256)
    e, V = O.graph_laplacian(_t(pc), 20)
    ep, Vp = O.graph_laplacian_partial(
        _t(pc), 20, 30, generator=torch.Generator().manual_seed(0))
    for b in range(2):
        assert _subspace_dist(V[b, :, :30].numpy(), Vp[b].numpy()) < 5e-3
    np.testing.assert_allclose(ep.numpy(), e[:, :30].numpy(), atol=1e-3)


# ---------------------------------------------------------------------------
# Trajectories under pinned noise
# ---------------------------------------------------------------------------

LP, KNN = 10, 8


def _noisy_gap_ok(pts, noise):
    """The low band of every restart's noisy cloud is well separated, as
    `test_low_band_projector_matches_jax` asks."""
    eps = np.finfo(np.float32).eps
    for s in range(noise.shape[0]):
        e = O.graph_laplacian(_t(pts + noise[s]), KNN)[0].numpy()
        assert ((e[:, LP] - e[:, LP - 1]) > 1000 * eps * e[:, -1]).all()


def _labels(jfn, xyz, targeted):
    """The victim's clean prediction (untargeted: there is something to
    flip), or its runner-up class (targeted)."""
    order = np.argsort(-np.asarray(jfn(jnp.asarray(xyz))), axis=1)
    return order[:, 1 if targeted else 0].astype(np.int32)


def _linf(budget, pkg):
    return lambda a, o: pkg.clip_points_linf(a, o, budget)


def _compare(got, want, atol):
    np.testing.assert_allclose(got.adv_points.numpy(),
                               np.asarray(want.adv_points), atol=atol)
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))


@pytest.mark.parametrize("mode", ["untargeted", "targeted", "ae_untargeted"])
def test_pinned_noise_aof_trajectory(victims, aes, mode):
    jfn, model = victims
    jae, tae = aes
    pts, _ = synthetic_clouds(4, N, seed=8)
    xyz = pts[..., :3].copy()
    noise = np.array(jax.random.normal(jax.random.PRNGKey(4),
                                       (2, 4, N, 3)) * 1e-7)
    _noisy_gap_ok(xyz, noise)
    targeted = mode == "targeted"
    labels = _labels(jfn, xyz, targeted)
    kw = dict(binary_step=2, num_iter=5, low_pass=LP, knn=KNN, mode=mode,
              gamma=0.25 if mode == "ae_untargeted" else 0.5)
    want = JO.make_aof(jfn, JB.make_adv_fn("logits", 0.0, targeted=targeted),
                       _linf(0.1, JL), JO.AOFConfig(**kw),
                       ae_fn=jae if mode == "ae_untargeted" else None,
                       init_overrides={"noise": noise})(
        jnp.asarray(xyz), jnp.asarray(labels), jax.random.PRNGKey(0))
    got = O.make_aof(model, make_adv_fn("logits", 0.0, targeted=targeted),
                     _linf(0.1, L), O.AOFConfig(**kw),
                     ae_fn=tae if mode == "ae_untargeted" else None,
                     init_overrides={"noise": noise}, device="cpu")(
        pts, labels)
    # the projectors agree to ~1e-6 at this gap, the victims' f32 sums
    # round in other orders; Adam's normalised steps (lr 1e-2) carry
    # that over 10 iterations: a hundredth of one step
    _compare(got, want, 1e-4)
    delta = np.abs(got.adv_points.numpy() - xyz).max()
    # TAOF alone skips the final clip: the low and high parts re-added
    # may pass the budget by rounding
    assert delta <= 0.1 + (1e-6 if targeted else 0.0)
    assert delta > 1e-3                                       # it moved


@pytest.mark.parametrize("targeted", [False, True])
def test_pinned_noise_advpc_trajectory(victims, aes, targeted):
    jfn, model = victims
    jae, tae = aes
    pts, _ = synthetic_clouds(4, N, seed=8)
    xyz = pts[..., :3].copy()
    labels = _labels(jfn, xyz, targeted)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(4),
                                       (2, 4, N, 3)) * 1e-7)
    kw = dict(binary_step=2, num_iter=5, targeted=targeted)
    want = JV.make_advpc(jfn, jae, JB.make_adv_fn("logits", 0.0,
                                                  targeted=targeted),
                         _linf(0.1, JL), JV.AdvPCConfig(**kw),
                         init_overrides={"noise": noise})(
        jnp.asarray(xyz), jnp.asarray(labels), jax.random.PRNGKey(0))
    got = make_advpc(model, tae, make_adv_fn("logits", 0.0,
                                             targeted=targeted),
                     _linf(0.1, L), AdvPCConfig(**kw),
                     init_overrides={"noise": noise}, device="cpu")(
        pts, labels)
    # the victims' and the AE's f32 sums in other orders, through 10 Adam
    # steps of 1e-2: a hundredth of one step
    _compare(got, want, 1e-4)
    delta = np.abs(got.adv_points.numpy() - xyz).max()
    assert 1e-3 < delta <= 0.1


def test_aof_and_advpc_need_a_generator_unless_pinned(victims, aes):
    _, model = victims
    _, tae = aes
    pts, labels = synthetic_clouds(2, N, seed=8)
    adv = make_adv_fn("logits", 0.0)
    aof = O.make_aof(model, adv, _linf(0.1, L), O.AOFConfig(
        binary_step=1, num_iter=2, low_pass=LP, knn=KNN), device="cpu")
    sub = O.make_aof(model, adv, _linf(0.1, L), O.AOFConfig(
        binary_step=1, num_iter=2, low_pass=LP, knn=KNN,
        eigensolver="subspace"), device="cpu")
    advpc = make_advpc(model, tae, adv, _linf(0.1, L),
                       AdvPCConfig(binary_step=1, num_iter=2), device="cpu")
    for attack in (aof, sub, advpc):
        with pytest.raises(ValueError, match="Generator"):
            attack(pts, labels)
        a = attack(pts, labels, torch.Generator().manual_seed(2))
        b = attack(pts, labels, torch.Generator().manual_seed(2))
        assert torch.equal(a.adv_points, b.adv_points)
        assert np.abs(a.adv_points.numpy() - pts[..., :3]).max() <= 0.1
    with pytest.raises(ValueError, match="ae_fn"):
        O.make_aof(model, adv, _linf(0.1, L),
                   O.AOFConfig(mode="ae_untargeted"), device="cpu")


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

def test_lpips_matches_jax(victims):
    """`normalize_flatten_features` and `lpips_distance` on the PointNet
    feature stacks of two clouds: values and the gradient to the first."""
    tree = _np_tree(JP.init(jax.random.PRNGKey(42)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    _, model = victims
    a, b = _cloud(9), _cloud(10)
    jf = [np.asarray(f) for f in JP.features(params, jnp.asarray(a))]
    tf = [f.numpy() for f in model.features(_t(a))]
    # f32 sums in other orders
    np.testing.assert_allclose(
        L.normalize_flatten_features([_t(f) for f in tf]).numpy(),
        np.asarray(JL.normalize_flatten_features(
            [jnp.asarray(f) for f in jf])), rtol=1e-4, atol=1e-6)
    want, jg = jax.value_and_grad(lambda x: jnp.sum(JL.lpips_distance(
        JP.features(params, x), JP.features(params, jnp.asarray(b)))))(
            jnp.asarray(a))
    x = _t(a, True)
    got = L.lpips_distance(model.features(x), model.features(_t(b))).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg),
                               atol=1e-4 * np.abs(np.asarray(jg)).max())
