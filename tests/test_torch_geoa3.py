"""GeoA3 in the port against `hitadv_tpu` on the CPU: the losses of
`losses/geoa3.py` and the GeoA3 terms of `losses/distance.py` (values
and input gradients), the normal estimators, GeoA3's PointNet (logits
and input gradient, carried directly and through ``TORCH_SPEC``), the
attack's trajectory under pinned draws, and the .mat loader.

The JAX side runs its XLA path, whose kNN takes matmul distances where
the port takes the elementwise form: the loss tests assert first that
the 1-NN indices agree on their clouds, and their adversarial clouds sit
5e-2 from the clean ones, where the matmul form's gradient is accurate.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu import losses as JL
from hitadv_tpu.attacks import geoa3 as JA
from hitadv_tpu.data import geoa3_mat as JM
from hitadv_tpu.data import synthetic_clouds
from hitadv_tpu.losses import geoa3 as JG3
from hitadv_tpu.models import geoa3_pointnet as JPN
from hitadv_tpu.models import pointnet as JP
from hitadv_tpu.ops import geometry as JG
from hitadv_tpu.utils import checkpoint as JCK
from hitadv_torch import config as CFG
from hitadv_torch import eval as EV
from hitadv_torch import losses as L
from hitadv_torch.attacks import geoa3 as A
from hitadv_torch.convert import params_from_numpy
from hitadv_torch.data import geoa3_mat as M
from hitadv_torch.losses import geoa3 as G3
from hitadv_torch.models import GeoA3PointNet, PointNet, get_model
from hitadv_torch.models import geoa3_pointnet as PN
from hitadv_torch.ops import geometry as G
from hitadv_torch.utils import checkpoint as CK
from test_torch_kernels import one_torch_thread  # noqa: F401

PKL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "asr_victim_params.pkl")
# the GeoA3 trajectory test's start displacement, in units of the
# attack's own 1e-7
START = 1e5


@pytest.fixture(autouse=True)
def xla_backend():
    prev = JG.get_backend()
    JG.set_backend("xla")
    try:
        yield
    finally:
        JG.set_backend(prev)


def _clouds(seed, B=2, N=96):
    """(adv, ori, unit normals): clean points on a sphere's patch with
    noise, adv 5e-2 off them."""
    rng = np.random.RandomState(seed)
    ori = rng.randn(B, N, 3).astype(np.float32) * 0.5
    adv = ori + 0.05 * rng.randn(B, N, 3).astype(np.float32)
    n = rng.randn(B, N, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return adv, ori, n


def _nn_indices_agree(a, o):
    for q, p in ((a, o), (o, a)):
        want = np.asarray(JG.knn_points(jnp.asarray(q), jnp.asarray(p),
                                        1).idx)
        got = G.knn_points(torch.from_numpy(q), torch.from_numpy(p),
                           1).idx.numpy()
        np.testing.assert_array_equal(got, want)


K = 8
LOSSES = {
    "norm_l2": (lambda a, o, n: JG3.norm_l2_loss(a, o),
                lambda a, o, n: G3.norm_l2_loss(a, o)),
    "chamfer": (lambda a, o, n: JG3.chamfer_loss(a, o),
                lambda a, o, n: G3.chamfer_loss(a, o)),
    "pseudo_chamfer": (lambda a, o, n: JG3.pseudo_chamfer_loss(a, o),
                       lambda a, o, n: G3.pseudo_chamfer_loss(a, o)),
    "hausdorff": (lambda a, o, n: JG3.hausdorff_loss(a, o),
                  lambda a, o, n: G3.hausdorff_loss(a, o)),
    "curvature": (
        lambda a, o, n: JG3.curvature_loss(
            a, o, JL.get_kappa_adv(a, o, n, K)[0], JL.get_kappa(o, n, K)),
        lambda a, o, n: G3.curvature_loss(
            a, o, L.get_kappa_adv(a, o, n, K)[0], L.get_kappa(o, n, K))),
    "displacement": (lambda a, o, n: JG3.displacement_loss(a, o, K),
                     lambda a, o, n: G3.displacement_loss(a, o, K)),
    "corresponding_normal": (
        lambda a, o, n: JG3.corresponding_normal_loss(a, n, 3),
        lambda a, o, n: G3.corresponding_normal_loss(a, n, 3)),
    "repulsion": (lambda a, o, n: JG3.repulsion_loss(a, 4, 0.3),
                  lambda a, o, n: G3.repulsion_loss(a, 4, 0.3)),
    "distance_kmean": (lambda a, o, n: JG3.distance_kmean_loss(a, 5),
                       lambda a, o, n: G3.distance_kmean_loss(a, 5)),
    "knn_smoothing": (lambda a, o, n: JG3.knn_smoothing_loss(a, 5),
                      lambda a, o, n: G3.knn_smoothing_loss(a, 5)),
    "laplacian": (
        lambda a, o, n: JL.laplacian_dist(a, o, JG.knn_indices(o, K)[1]),
        lambda a, o, n: L.laplacian_dist(a, o, G.knn_indices(o, K)[1])),
    "kappa_adv": (lambda a, o, n: JL.get_kappa_adv(a, o, n, K)[0],
                  lambda a, o, n: L.get_kappa_adv(a, o, n, K)[0]),
    "kappa_adv_normal": (lambda a, o, n: JL.get_kappa_adv(a, o, n, K)[1],
                         lambda a, o, n: L.get_kappa_adv(a, o, n, K)[1]),
    "curv_dist": (lambda a, o, n: JL.curv_dist(o, a, n, K),
                  lambda a, o, n: L.curv_dist(o, a, n, K)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_values_and_input_grads(name):
    jf, tf = LOSSES[name]
    a, o, n = _clouds(1)
    if name == "distance_kmean":
        # on a grid of 1/64 every product of the matmul distance form is
        # exact, so no self distance rounds below zero: elsewhere its
        # square root is NaN, and so is the gradient, in both packages
        a = np.round(a * 64) / 64
    _nn_indices_agree(a, o)
    out = np.asarray(jf(jnp.asarray(a), jnp.asarray(o), jnp.asarray(n)))
    w = np.random.RandomState(2).randn(*out.shape).astype(np.float32)
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(
        jf(a, jnp.asarray(o), jnp.asarray(n)) * w))(jnp.asarray(a)))
    at = torch.tensor(a, requires_grad=True)
    got = tf(at, torch.from_numpy(o), torch.from_numpy(n))
    if got.requires_grad:
        (got * torch.from_numpy(w)).sum().backward()
    # f32 sums in other orders, and the matmul distance form on the JAX
    # side (distances of O(1) rounded to ~1e-7)
    np.testing.assert_allclose(got.detach().numpy(), out, rtol=1e-4,
                               atol=1e-5)
    g = np.zeros_like(a) if at.grad is None else at.grad.numpy()
    np.testing.assert_allclose(g, want_g, rtol=1e-3,
                               atol=1e-4 * max(np.abs(want_g).max(), 1e-6))


def test_jitter_input_bounds():
    j = G3.jitter_input(torch.Generator().manual_seed(0), (2, 500, 3),
                        0.1, 0.05)
    assert j.abs().max() <= 0.05 and (j.abs() == 0.05).any()
    assert (j.abs() < 0.05).float().mean() > 0.3


def test_normal_estimators_match_jax():
    pts, _ = synthetic_clouds(2, 128, seed=3)
    pc = pts[..., :3].copy()
    want = np.asarray(JG3.estimate_normal(jnp.asarray(pc), 10))
    got = G3.estimate_normal(torch.from_numpy(pc), 10).numpy()
    # both orient their eigenvector; eigh of 3x3 f32 matrices in two
    # libraries
    np.testing.assert_allclose(got, want, atol=1e-4)
    a, o, n = _clouds(4)
    want = np.asarray(JG3.estimate_normal_via_ori_normal(
        jnp.asarray(a), jnp.asarray(o), jnp.asarray(n), 4))
    got = G3.estimate_normal_via_ori_normal(
        torch.from_numpy(a), torch.from_numpy(o), torch.from_numpy(n),
        4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_estimate_perpendicular_term_by_term():
    """JAX's jitter against the port's two terms ``clamp(v_i a_i)`` under
    the same draws (one draw zeroed to isolate each term), up to the sign
    of each eigenvector, which neither eigh fixes; at the points whose
    three eigenvalues stand apart (else the eigenvectors themselves are
    ill-conditioned)."""
    pts, _ = synthetic_clouds(2, 128, seed=5)
    pc = pts[..., :3].copy()
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    a1 = np.array(jax.random.normal(k1, (2, 128, 1)))
    a2 = np.array(jax.random.normal(k2, (2, 128, 1)))
    want = np.asarray(JG3.estimate_perpendicular(jnp.asarray(pc), 10, key,
                                                 sigma=1.0, clip=0.3))
    pt = torch.from_numpy(pc)
    t1, t2 = (G3.estimate_perpendicular(
        pt, 10, sigma=1.0, clip=0.3, draws=(torch.from_numpy(d1),
                                            torch.from_numpy(d2))).numpy()
        for d1, d2 in ((a1, 0 * a2), (0 * a1, a2)))
    cov, _ = JG3._knn_ring_covariance(jnp.asarray(pc), 10)
    lam = np.linalg.eigvalsh(np.asarray(cov, np.float64))   # ascending
    apart = np.min(np.diff(lam, axis=-1), axis=-1) > 1e-2 * lam[..., 2]
    assert apart.mean() > 0.8
    err = np.min([np.abs(s1 * t1 + s2 * t2 - want).max(-1)
                  for s1 in (-1, 1) for s2 in (-1, 1)], axis=0)
    assert err[apart].max() < 1e-4, err[apart].max()
    assert np.abs(t1).max() > 0.1 and np.abs(t2).max() > 0.1
    assert G3.estimate_perpendicular(pt, 10, torch.Generator().manual_seed(
        1)).shape == (2, 128, 3)


@pytest.fixture(scope="module")
def victim_tree():
    """JAX's GeoA3 PointNet tree (10 classes) with random BN statistics."""
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        JPN.init, static_argnums=1)(jax.random.PRNGKey(2), 10))
    rng = np.random.RandomState(0)

    def jitter(node):
        if "var" in node:
            c = node["var"].shape[0]
            node.update(scale=1 + 0.2 * rng.randn(c).astype(np.float32),
                        bias=0.1 * rng.randn(c).astype(np.float32),
                        mean=0.1 * rng.randn(c).astype(np.float32),
                        var=(0.5 + rng.rand(c)).astype(np.float32))
            return
        for v in node.values():
            if isinstance(v, dict):
                jitter(v)

    jitter(tree)
    return tree


def _logits_and_grad(jtree, model, x, w):
    (_, lg), g = jax.jit(jax.value_and_grad(
        lambda x: (jnp.sum(JPN.apply(jtree, x) * w), JPN.apply(jtree, x)),
        has_aux=True))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = model(xt)
    (got * torch.from_numpy(w)).sum().backward()
    return (got.detach().numpy(), np.asarray(lg)), (xt.grad.numpy(),
                                                    np.asarray(g))


def test_victim_logits_and_input_grad(victim_tree):
    model = GeoA3PointNet(params=params_from_numpy(victim_tree, "cpu"),
                          device="cpu")
    assert get_model("geoa3_pointnet") is GeoA3PointNet
    assert model.num_classes == 10
    x = np.random.RandomState(1).randn(2, 64, 3).astype(np.float32) * 0.5
    w = np.random.RandomState(2).randn(2, 10).astype(np.float32)
    (lg, jlg), (g, jg) = _logits_and_grad(victim_tree, model, x, w)
    np.testing.assert_allclose(lg, jlg, rtol=1e-4, atol=1e-5)
    # f32 products in other orders through 1024-wide layers and a
    # kernel-3 conv (~1e-6 relative each)
    np.testing.assert_allclose(g, jg, rtol=1e-3, atol=1e-4 * np.abs(jg).max())
    # the kernel-3 conv sees the point order: a shuffle changes logits
    perm = np.random.RandomState(3).permutation(64)
    with torch.no_grad():
        shuffled = model(torch.from_numpy(x[:, perm].copy())).numpy()
    assert np.abs(shuffled - lg).max() > 1e-4
    # a fresh model: seeded, identity transforms at init
    fresh = GeoA3PointNet(10, device="cpu")
    assert torch.equal(fresh.params["input_transform"]["fc3"]["b"],
                       torch.eye(3).reshape(-1))
    assert not fresh.params["input_transform"]["fc3"]["w"].any()


def _state_dict(tree, spec, rng):
    """A reference-layout torch state dict for ``spec`` with ``tree``'s
    shapes: Conv1d weights [Cout, Cin, 1] ("conv") or [Cout, Cin, K]
    ("conv1d"), Linear [Cout, Cin], BN with statistics."""
    sd = {}
    for path, (prefix, kind) in spec.items():
        leaf = tree
        for part in path.split("/"):
            leaf = leaf[part]
        if kind == "bn":
            c = leaf["scale"].shape[0]
            sd.update({f"{prefix}.weight": 1 + 0.2 * rng.randn(c),
                       f"{prefix}.bias": 0.1 * rng.randn(c),
                       f"{prefix}.running_mean": 0.1 * rng.randn(c),
                       f"{prefix}.running_var": 0.5 + rng.rand(c),
                       f"{prefix}.num_batches_tracked": np.array(3)})
            continue
        w = leaf["w"]
        cout = w.shape[-1]
        sd[f"{prefix}.weight"] = (
            rng.randn(*w.shape).transpose(2, 1, 0) / np.sqrt(w[0].size)
            if kind == "conv1d" else
            rng.randn(cout, w.shape[0], *(1,) * (kind == "conv"))
            / np.sqrt(w.shape[0]))
        sd[f"{prefix}.bias"] = 0.1 * rng.randn(cout)
    return {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
            for k, v in sd.items()}


def test_torch_spec_conversion_and_build_model(victim_tree, tmp_path):
    assert PN.TORCH_SPEC == JPN.TORCH_SPEC
    sd = _state_dict(victim_tree, PN.TORCH_SPEC, np.random.RandomState(4))
    got = CK.convert_state_dict(sd, PN.TORCH_SPEC)
    want = JCK.convert_state_dict(sd, JPN.TORCH_SPEC)
    assert got["conv5"]["w"].shape == (3, 128, 1024)
    np.testing.assert_array_equal(got["conv5"]["w"],
                                  np.asarray(want["conv5"]["w"]))
    path = str(tmp_path / "geoa3.pth")
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v))
                                     for k, v in sd.items()}}, path)
    model = EV.build_model(CFG.EvalConfig(model="geoa3_pointnet",
                                          checkpoint=path, device="cpu"))
    x = np.random.RandomState(5).randn(2, 64, 3).astype(np.float32) * 0.5
    w = np.random.RandomState(6).randn(2, 10).astype(np.float32)
    (lg, jlg), (g, jg) = _logits_and_grad(want, model, x, w)
    np.testing.assert_allclose(lg, jlg, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g, jg, rtol=1e-3, atol=1e-4 * np.abs(jg).max())


@pytest.mark.parametrize("targeted", [True, False])
def test_geoa3_trajectory_matches_jax(targeted, monkeypatch):
    """2 binary steps x 5 Adam iterations against the committed trained
    PointNet (10 classes, 64-point clouds: a victim whose predictions
    move, unlike a random GeoA3 PointNet's constant class), targeted at
    each cloud's runner-up class or untargeted, under the same start
    draws on both sides.

    The start is JAX's normal draws times 1e-2 in both packages (the JAX
    attack's draws scaled, the port's pinned): at the attack's own 1e-7,
    the curvature term's first gradients are differences of kappas equal
    to f32 rounding, which Adam's normalised steps turn into different
    first moves (measured: up to 8e-3 apart after 2 x 5); from 1e-2 the
    two trajectories stay within 4e-5."""
    tree = CK.load_params(PKL)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jfn = jax.jit(lambda x: JP.apply(jtree, x))
    model = PointNet(params=params_from_numpy(tree, "cpu"), device="cpu")
    pts, labels = synthetic_clouds(4, 64, num_classes=10, seed=6)
    if targeted:
        logits = np.asarray(jfn(jnp.asarray(pts[..., :3])))
        labels = np.argsort(logits, axis=-1)[:, -2].astype(np.int32)
    kw = dict(binary_max_steps=2, iter_max_steps=5, curv_loss_knn=8,
              targeted=targeted)
    key = jax.random.PRNGKey(4)
    real = jax.random.normal
    noise = np.stack([np.array(real(jax.random.split(k)[0], pts[..., :3]
                                    .shape) * 1e-7 * START)
                      for k in jax.random.split(key, 2)])
    monkeypatch.setattr(jax.random, "normal",
                        lambda *a, **k: real(*a, **k) * START)
    want = JA.make_geoa3(jfn, JA.GeoA3Config(**kw))(
        jnp.asarray(pts), jnp.asarray(labels), key)
    monkeypatch.setattr(jax.random, "normal", real)
    got = A.make_geoa3(model, A.GeoA3Config(**kw),
                       init_overrides={"noise": noise}, device="cpu")(
        pts, labels)
    # f32 sums in other orders, through Adam's normalised steps of 1e-2:
    # a hundredth of a step
    np.testing.assert_allclose(got.adv_points.numpy(),
                               np.asarray(want.adv_points), atol=1e-4)
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    assert np.abs(got.adv_points.numpy() - pts[..., :3]).max() > 0.05
    assert got.success.any()


def test_geoa3_needs_a_generator_unless_pinned(victim_tree):
    model = GeoA3PointNet(params=params_from_numpy(victim_tree, "cpu"),
                          device="cpu")
    pts, labels = synthetic_clouds(2, 32, num_classes=10, seed=7)
    cfg = A.GeoA3Config(binary_max_steps=1, iter_max_steps=2,
                        curv_loss_knn=4)
    attack = A.make_geoa3(model, cfg, device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        attack(pts, labels)
    a = attack(pts, labels, torch.Generator().manual_seed(1))
    b = attack(pts, labels, torch.Generator().manual_seed(1))
    assert torch.equal(a.adv_points, b.adv_points)
    # two Adam steps of lr 0.01 from the 1e-7 start
    disp = (a.adv_points - torch.from_numpy(pts[..., :3])).abs().max()
    assert 0.0 < disp <= 0.02 + 1e-6
    with pytest.raises(ValueError, match="lacks"):
        A.make_geoa3(model, cfg, init_overrides={}, device="cpu")


@pytest.mark.parametrize("mode", ["All", "Untarget", "Random", "chair"])
def test_mat_loader_matches_jax(mode, tmp_path):
    from scipy.io import savemat

    rng = np.random.RandomState(8)
    M_, N = 130, 40
    data = rng.randn(M_, 3, N).astype(np.float32)
    normal = rng.randn(M_, 3, N).astype(np.float32)
    label = rng.choice(M.TEN_LABEL_INDEXES, size=(M_, 1))
    path = str(tmp_path / "geoa3.mat")
    savemat(path, {"data": data, "normal": normal, "label": label})
    for resample in (-1, 16):
        got = M.GeoA3ModelNet40(path, mode, resample, seed=3)
        want = JM.GeoA3ModelNet40(path, mode, resample, seed=3)
        assert len(got) == len(want) == (25 if mode == "chair" else M_)
        for i in (0, 7, len(got) - 1):
            for a, b in zip(got[i], want[i]):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="attack_label"):
        M.GeoA3ModelNet40(path, "nope")
