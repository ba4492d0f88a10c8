"""The port's CW attacks, distances and clips against `hitadv_tpu`.

Both packages get the same numpy inputs, the same parameter tree and the
same pinned noise. The port runs on the CPU.

The trajectory tests put the JAX side on its Pallas path (interpret
mode). There the kNN distance's backward is the kernel's custom VJP,
``2 g (q - p)``, as in the port. The XLA path differentiates the matmul
form ``|q|^2 - 2 q.p + |p|^2`` instead. For an iterate 1e-7 from its
nearest original point, that gradient is f32 rounding noise, and Adam
normalises it into a full step, so the two paths part within a few
iterations.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu import losses as JL
from hitadv_tpu.attacks import base as JB
from hitadv_tpu.attacks import cw as JC
from hitadv_tpu.data import synthetic_clouds
from hitadv_tpu.models import pointnet as JP
from hitadv_tpu.ops import geometry as JG
from hitadv_torch import losses as L
from hitadv_torch.attacks import CWConfig, CWKNNConfig, make_adv_fn
from hitadv_torch.attacks import make_cw_knn, make_cw_perturb
from hitadv_torch.convert import load_numpy_params, params_from_numpy
from hitadv_torch.models import PointNet
from test_torch_kernels import one_torch_thread  # noqa: F401

PKL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "asr_victim_params.pkl")


@pytest.fixture(autouse=True)
def xla_backend():
    """The JAX side on its plain XLA path unless a test says otherwise;
    the knob is restored after."""
    prev = JG.get_backend()
    JG.set_backend("xla")
    try:
        yield
    finally:
        JG.set_backend(prev)


@pytest.fixture(scope="module")
def victims():
    """(JAX logits fn, port model) sharing one random parameter tree."""
    tree = jax.tree_util.tree_map(np.asarray, JP.init(jax.random.PRNGKey(42)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = PointNet(params=params_from_numpy(tree, "cpu"), device="cpu")
    return (lambda x: JP.apply(params, x)), model


def _cloud(seed, B=2, N=100):
    return np.random.RandomState(seed).randn(B, N, 3).astype(np.float32) * 0.5


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _value_and_grads(jf, tf, a, o):
    """Values and the gradients of ``sum(f(a, o) * w)`` in both packages."""
    w = np.random.RandomState(9).randn(a.shape[0]).astype(np.float32)
    want, (ga, go) = jax.value_and_grad(
        lambda a, o: jnp.sum(jf(a, o) * w), argnums=(0, 1))(jnp.asarray(a),
                                                            jnp.asarray(o))
    want_v = np.asarray(jf(jnp.asarray(a), jnp.asarray(o)))
    at, ot = _t(a, True), _t(o, True)
    got = tf(at, ot)
    (got * _t(w)).sum().backward()
    return ((got.detach().numpy(), want_v),
            (at.grad.numpy(), np.asarray(ga)),
            (np.zeros_like(o) if ot.grad is None else ot.grad.numpy(),
             np.asarray(go)))


def test_l2_dist():
    a, o = _cloud(0), _cloud(1)
    for got, want in _value_and_grads(JL.l2_dist, L.l2_dist, a, o):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["chamfer_dist", "hausdorff_dist"])
@pytest.mark.parametrize("method", ["adv2ori", "ori2adv", "both"])
def test_set_distances_values_and_grads(name, method):
    a, o = _cloud(2, N=100), _cloud(3, N=120)
    jf = lambda a, o: getattr(JL, name)(a, o, method=method)   # noqa: E731
    tf = lambda a, o: getattr(L, name)(a, o, method=method)    # noqa: E731
    # the XLA path takes the matmul distance form, the port the
    # elementwise one: f32 rounding of O(1) squared distances
    for got, want in _value_and_grads(jf, tf, a, o):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        L.chamfer_dist(_t(a), _t(o), method="sideways")


@pytest.mark.parametrize("k,alpha", [(5, 1.05), (3, 0.5)])
def test_knn_dist_and_chamfer_knn_dist(k, alpha):
    a, o = _cloud(4, N=128), _cloud(5, N=128)
    a[:, :4] *= 3.0                          # a few outliers
    for got, want in _value_and_grads(
            lambda a, o: JL.knn_dist(a, k=k, alpha=alpha),
            lambda a, o: L.knn_dist(a, k=k, alpha=alpha), a, o):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for got, want in _value_and_grads(JL.chamfer_knn_dist,
                                      L.chamfer_knn_dist, a, o):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _clip_inputs():
    rng = np.random.RandomState(6)
    o = _cloud(7, N=64)
    n = rng.randn(2, 64, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = 0.2 * rng.randn(2, 64, 3).astype(np.float32)
    d[:, :5] = -0.3 * n[:, :5]              # anti-parallel: zeroed
    d[:, 5:10] = 0.3 * n[:, 5:10]           # outward: kept
    return o + d, o, n


@pytest.mark.parametrize("which", ["l2", "linf", "inner", "inner_none",
                                   "inner_linf"])
def test_clips_values_and_grads(which):
    pc, o, n = _clip_inputs()
    fns = {
        "l2": (lambda p, o: JL.clip_points_l2(p, o, 0.5),
               lambda p, o: L.clip_points_l2(p, o, 0.5)),
        "linf": (lambda p, o: JL.clip_points_linf(p, o, 0.1),
                 lambda p, o: L.clip_points_linf(p, o, 0.1)),
        "inner": (lambda p, o: JL.project_inner_points(p, o, jnp.asarray(n)),
                  lambda p, o: L.project_inner_points(p, o, _t(n))),
        "inner_none": (lambda p, o: JL.project_inner_points(p, o, None),
                       lambda p, o: L.project_inner_points(p, o, None)),
        "inner_linf": (
            lambda p, o: JL.project_inner_clip_linf(p, o, 0.1,
                                                    jnp.asarray(n)),
            lambda p, o: L.project_inner_clip_linf(p, o, 0.1, _t(n))),
    }
    jf, tf = fns[which]
    want = np.asarray(jf(jnp.asarray(pc), jnp.asarray(o)))
    w = np.random.RandomState(8).randn(*pc.shape).astype(np.float32)
    want_g = np.asarray(jax.grad(lambda p: jnp.sum(
        jf(p, jnp.asarray(o)) * w))(jnp.asarray(pc)))
    pt = _t(pc, True)
    got = tf(pt, _t(o))
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), want_g, rtol=1e-5, atol=1e-5)
    if which == "inner":                    # the anti-parallel points
        np.testing.assert_array_equal(got.detach().numpy()[:, :5], o[:, :5])


def _labels_of(jfn, pts):
    return np.array(jnp.argmax(jax.jit(jfn)(jnp.asarray(pts[..., :3])), -1),
                    np.int32)


def test_pinned_noise_cw_perturb_trajectory(victims):
    JG.set_backend("pallas")
    jfn, model = victims
    pts, _ = synthetic_clouds(4, 128, seed=3)
    labels = _labels_of(jfn, pts)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                       (2, 4, 128, 3)) * 1e-7)
    kw = dict(binary_step=2, num_iter=15, targeted=False)
    want = JC.make_cw_perturb(
        jfn, JB.make_adv_fn("logits", 0.0, targeted=False),
        dist_fn=JL.chamfer_dist, cfg=JC.CWConfig(**kw),
        init_overrides={"noise": noise})(
        jnp.asarray(pts[..., :3]), jnp.asarray(labels), jax.random.PRNGKey(0))
    got = make_cw_perturb(model, make_adv_fn("logits", 0.0), L.chamfer_dist,
                          CWConfig(**kw), init_overrides={"noise": noise},
                          device="cpu")(pts, labels)
    # f32 on both sides in other op orders (~1e-7 per step); a kNN
    # near-tie between the two distance forms would part them (other
    # cloud seeds do), this one has none
    np.testing.assert_allclose(got.adv_points.numpy(),
                               np.asarray(want.adv_points), atol=1e-5)
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))
    assert got.success.any() and not got.success.all()


def test_pinned_noise_cw_knn_trajectory(victims):
    JG.set_backend("pallas")
    jfn, model = victims
    pts, _ = synthetic_clouds(4, 128, seed=2)
    labels = _labels_of(jfn, pts)
    key = jax.random.PRNGKey(0)
    noise = np.array(jax.random.normal(key, (4, 128, 3)) * 1e-7)
    want = JC.make_cw_knn(
        jfn, JB.make_adv_fn("logits", 0.0, targeted=False),
        dist_fn=JL.chamfer_knn_dist,
        clip_fn=lambda a, o, n: JL.project_inner_clip_linf(a, o, 0.1, n),
        cfg=JC.CWKNNConfig(num_iter=20, targeted=False))(
        jnp.asarray(pts), jnp.asarray(labels), key)
    got = make_cw_knn(
        model, make_adv_fn("logits", 0.0), L.chamfer_knn_dist,
        clip_fn=lambda a, o, n: L.project_inner_clip_linf(a, o, 0.1, n),
        cfg=CWKNNConfig(num_iter=20, targeted=False), init_noise=noise,
        device="cpu")(pts, labels)
    adv = got.adv_points.numpy()
    # f32 sums in other orders, amplified by Adam's normalised steps over
    # 20 iterations: a tenth of one 1e-3 step
    np.testing.assert_allclose(adv, np.asarray(want.adv_points), atol=1e-4)
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))
    assert np.abs(adv - pts[..., :3]).max() <= 0.1 + 1e-6
    assert np.abs(adv - pts[..., :3]).max() > 0.01      # it moved


def test_cw_uknn_asr_on_trained_victim_matches_jax_run():
    """CW-UKNN on the committed trained victim (64 clouds x 64 points, a
    shortened 100-step schedule at lr 1e-2, budget 0.2), same initial
    noise on both sides: ASR within one example of the JAX run."""
    tree = load_numpy_params(PKL)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jfn = jax.jit(lambda x: JP.apply(params, x))
    model = PointNet(params=params_from_numpy(tree, "cpu"), device="cpu")
    pts, labels = synthetic_clouds(64, 64, num_classes=10, seed=99)
    mask = np.asarray(jnp.argmax(jfn(jnp.asarray(pts[..., :3])), -1)) \
        == labels
    key = jax.random.PRNGKey(0)
    noise = np.array(jax.random.normal(key, (64, 64, 3)) * 1e-7)
    kw = dict(num_iter=100, targeted=False, attack_lr=1e-2)
    want = JC.make_cw_knn(
        jfn, JB.make_adv_fn("logits", 0.0, targeted=False),
        dist_fn=JL.chamfer_knn_dist,
        clip_fn=lambda a, o, n: JL.project_inner_clip_linf(a, o, 0.2, n),
        cfg=JC.CWKNNConfig(**kw))(jnp.asarray(pts), jnp.asarray(labels), key)
    got = make_cw_knn(
        model, make_adv_fn("logits", 0.0), L.chamfer_knn_dist,
        clip_fn=lambda a, o, n: L.project_inner_clip_linf(a, o, 0.2, n),
        cfg=CWKNNConfig(**kw), init_noise=noise, device="cpu")(pts, labels)
    flips_j = int(((np.asarray(want.pred) != labels) & mask).sum())
    flips_t = int(((got.pred.numpy() != labels) & mask).sum())
    assert 0.2 < flips_j / mask.sum() < 0.9
    assert abs(flips_t - flips_j) <= 1, (flips_t, flips_j, mask.sum())


def test_attacks_need_a_generator_unless_pinned(victims):
    _, model = victims
    pts, labels = synthetic_clouds(2, 64, seed=8)
    perturb = make_cw_perturb(model, make_adv_fn("logits", 0.0),
                              cfg=CWConfig(binary_step=1, num_iter=2,
                                           targeted=False), device="cpu")
    knn = make_cw_knn(model, make_adv_fn("logits", 0.0), L.chamfer_knn_dist,
                      cfg=CWKNNConfig(num_iter=2, targeted=False),
                      device="cpu")
    for attack in (perturb, knn):
        with pytest.raises(ValueError, match="Generator"):
            attack(pts, labels)
        a = attack(pts, labels, torch.Generator().manual_seed(2))
        b = attack(pts, labels, torch.Generator().manual_seed(2))
        assert torch.equal(a.adv_points, b.adv_points)
        assert a.adv_points.shape == (2, 64, 3)
