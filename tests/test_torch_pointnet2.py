"""The port's PointNet++ (SSG) against `hitadv_tpu.models.pointnet2`, and
HiT-ADV against it.

One numpy parameter tree (the JAX init, with random BN statistics so that
the fold is exercised) feeds both packages through `params_from_numpy`.
The JAX side runs its plain XLA path; the port runs on the CPU, where its
kernels take their plain versions. The stage sizes are fixed by
`SSG_STAGES` (512 and 128 centres), so the clouds keep N=1024.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu.attacks import base as JB
from hitadv_tpu.attacks import hit_adv as JH
from hitadv_tpu.data import synthetic_clouds
from hitadv_tpu.models import pointnet2 as JP
from hitadv_tpu.nn import functional as jnnF
from hitadv_tpu.ops import geometry as JG
from hitadv_torch.attacks import base as B
from hitadv_torch.attacks import hit_adv as H
from hitadv_torch.convert import params_from_numpy
from hitadv_torch.models import PointNet2, get_model
from hitadv_torch.models import pointnet2 as P
from hitadv_torch.nn import functional as F
from hitadv_torch.ops import geometry as G
from test_torch_kernels import one_torch_thread  # noqa: F401

SMALL_ATTACK = dict(binary_step=2, num_iter=8, central_num=16,
                    total_central_num=32, curv_loss_knn=8)


@pytest.fixture(autouse=True)
def jax_knobs():
    """These tests set the JAX package's compute dtype and geometry
    backend; both are restored after each test."""
    dtype, backend = jnnF.get_compute_dtype(), JG.get_backend()
    JG.set_backend("xla")
    try:
        yield
    finally:
        jnnF.set_compute_dtype(dtype)
        JG.set_backend(backend)


def random_bn(tree, seed=0):
    """The tree with non-trivial BN statistics in every BN node."""
    rng = np.random.RandomState(seed)

    def visit(node):
        for v in node.values():
            if not isinstance(v, dict):
                continue
            if set(v) == {"scale", "bias", "mean", "var"}:
                c = v["var"].shape[0]
                v.update(scale=1 + 0.2 * rng.randn(c).astype(np.float32),
                         bias=0.1 * rng.randn(c).astype(np.float32),
                         mean=0.1 * rng.randn(c).astype(np.float32),
                         var=(0.5 + rng.rand(c)).astype(np.float32))
            else:
                visit(v)
    visit(tree)
    return tree


@pytest.fixture(scope="module")
def tree():
    return random_bn(jax.tree_util.tree_map(
        np.asarray, JP.init(jax.random.PRNGKey(3), num_classes=10)))


@pytest.fixture(scope="module")
def jax_value_and_grad(tree):
    """The JAX logits and the gradient of ``sum(logits * w)``, jitted once
    for the module (f32)."""
    def loss(x, w):
        lg = JP.apply(tree, x)
        return jnp.sum(lg.astype(jnp.float32) * w), lg

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True))

    def run(x, w):
        (_, lg), g = fn(jnp.asarray(x), jnp.asarray(w))
        return np.asarray(lg.astype(jnp.float32)), np.asarray(g)
    return run


def _model(tree, **kw):
    return PointNet2(params=params_from_numpy(tree, "cpu"), device="cpu",
                     **kw)


def _cloud(Bn, N=1024, seed=1):
    return np.random.RandomState(seed).randn(Bn, N, 3).astype(np.float32) * .5


def ball_indices(geo, xyz):
    """The two sampled stages' ball-query indices through ``geo`` (either
    package's geometry module): FPS from index 0, the centre gather, the
    ball query, as `_sa_apply` runs them."""
    out = []
    for cfg in P.SSG_STAGES[:2]:
        new_xyz = geo.index_points(xyz, geo.farthest_point_sample(
            xyz, cfg.npoint))
        out.append(np.asarray(geo.query_ball_point(cfg.radius, cfg.nsample,
                                                   xyz, new_xyz)))
        xyz = new_xyz
    return out


def test_get_model_and_params(tree):
    assert get_model("pointnet++") is PointNet2
    m = _model(tree)
    assert m.num_classes == 10 and not m.training
    assert not any(p.requires_grad for p in m.parameters())


def test_fresh_init_has_the_reference_tree_and_is_seeded():
    jtree = JP.init(jax.random.PRNGKey(0), num_classes=40)
    a = PointNet2(40, device="cpu", generator=torch.Generator().manual_seed(3))
    b = PointNet2(40, device="cpu", generator=torch.Generator().manual_seed(3))
    for name, node in jtree.items():
        flat = jax.tree_util.tree_leaves_with_path(node)
        for path, v in flat:
            keys = [k.key for k in path]
            t = a.params[name]
            for k in keys:
                t = t[k]
            assert tuple(t.shape) == v.shape, (name, keys)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PointNet2(10)


@pytest.mark.parametrize("seed", [1, 2])
def test_logits_and_input_grad_f32(tree, jax_value_and_grad, seed):
    x = _cloud(2, seed=seed)
    # the JAX XLA path takes the matmul form of the distance, the port the
    # elementwise one: a point within ~2e-7 of |d^2 - r^2| could change
    # balls. These seeds have no such point: the indices agree first.
    for want, got in zip(ball_indices(JG, jnp.asarray(x)),
                         ball_indices(G, torch.from_numpy(x))):
        np.testing.assert_array_equal(got, want)
    w = np.random.RandomState(2).randn(2, 10).astype(np.float32)
    want_lg, want_g = jax_value_and_grad(x, w)
    xt = torch.tensor(x, requires_grad=True)
    lg = _model(tree)(xt)
    (lg * torch.from_numpy(w)).sum().backward()
    # f32 on both sides, the same groups; sums in other orders, ~1e-6
    # relative per layer
    np.testing.assert_allclose(lg.detach().numpy(), want_lg, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=1e-3,
                               atol=1e-5)


def test_logits_bf16(tree):
    x = _cloud(2, seed=3)
    jnnF.set_compute_dtype(jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v: JP.apply(tree, v))(
        jnp.asarray(x)).astype(jnp.float32))
    got = _model(tree, compute_dtype=torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    # bf16 activations, rounded at other places by XLA's fusions and by
    # PyTorch's op-by-op execution: a few bf16 ulps of the logits (the
    # class of the DGCNN test)
    np.testing.assert_allclose(got.float().numpy(), want, atol=6e-2)
    np.testing.assert_array_equal(got.float().numpy().argmax(-1),
                                  want.argmax(-1))


def _grouped_reference(m, x):
    """The reference's formulation (`model/pointnet2_utils.py:110-138`):
    gather xyz and features, subtract the centre, concat, the full MLP,
    the max over the group axis."""
    p, xyz, pts = m.params, x, None
    for i, cfg in enumerate(P.SSG_STAGES, start=1):
        if cfg.group_all:
            xyz, grouped = G.sample_and_group_all(xyz, pts)
        else:
            xyz, grouped = G.sample_and_group(cfg.npoint, cfg.radius,
                                              cfg.nsample, xyz, pts)
        pts = F.max_mid(F.mlp_apply(p[f"sa{i}"], grouped))
    g = F.relu(F.linear_bn(p["fc1"], p["bn1"], pts[:, 0]))
    g = F.relu(F.linear_bn(p["fc2"], p["bn2"], g))
    return F.linear(p["fc3"], g)


def test_project_then_gather_matches_grouped_formulation(tree):
    """The port's eval stages against its own `sample_and_group` /
    `sample_and_group_all` formulation at the tolerance of the JAX
    package's test (`tests/test_project_then_gather.py`)."""
    m = _model(tree)
    x = torch.from_numpy(_cloud(2, seed=4))
    fused = m(x)
    ref = _grouped_reference(m, x)
    assert (fused - ref).abs().max().item() < 5e-6
    new_xyz, grouped = G.sample_and_group(512, 0.2, 32, x, None)
    fps_idx = G.farthest_point_sample(x, 512)
    assert grouped.shape == (2, 512, 32, 3) and fps_idx.shape == (2, 512)
    assert torch.equal(new_xyz, G.index_points(x, fps_idx))
    idx = G.query_ball_point(0.2, 32, x, new_xyz)
    assert torch.equal(grouped, G.index_points(x, idx) - new_xyz[:, :, None])


def _overrides(seed, S, Bn, Cn, budget):
    d = np.random.RandomState(seed)
    return {"pert": (d.rand(S, Bn, Cn, 3) * budget).astype(np.float32),
            "delta": (0.1 + d.rand(S, Bn, Cn) * 1.1).astype(np.float32)}


def test_pinned_draw_hit_adv_against_pointnet2(tree):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jfn = jax.jit(lambda x: JP.apply(params, x))
    model = _model(tree)
    pts, _ = synthetic_clouds(2, 1024, num_classes=10, seed=6)
    labels = np.array(jnp.argmax(jfn(jnp.asarray(pts[..., :3])), -1),
                      np.int32)
    ov = _overrides(12, SMALL_ATTACK["binary_step"], 2,
                    SMALL_ATTACK["central_num"], 0.55)
    want = JH.make_hit_adv(jfn, JB.make_adv_fn("logits", kappa=30.0),
                           JH.HiTADVConfig(**SMALL_ATTACK),
                           init_overrides=ov)(
        jnp.asarray(pts), jnp.asarray(labels), jax.random.PRNGKey(0))
    got = H.make_hit_adv(model, B.make_adv_fn("logits", kappa=30.0),
                         H.HiTADVConfig(**SMALL_ATTACK), init_overrides=ov,
                         device="cpu")(pts, labels)
    # f32 on both sides in other op orders, as for PointNet and DGCNN:
    # ~1e-6 per iteration, amplified by Adam's normalised steps
    np.testing.assert_allclose(got.adv_points.numpy(),
                               np.asarray(want.adv_points), atol=2e-3)
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))
