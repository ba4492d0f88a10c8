"""The port's PointConv against `hitadv_tpu.models.pointconv`, and HiT-ADV
against it.

One numpy parameter tree (the JAX init, with random BN statistics so that
the folds are exercised) feeds both packages through `params_from_numpy`.
DensityNet (1-16-8-1, a ReLU last) is dead, zero on (0, 1], in many
stages of random trees, and a dead stage's output does not depend on the
cloud; the tree's key (13) is one whose three DensityNets are live.
The JAX side runs its plain XLA path; the port runs on the CPU, where its
kernels take their plain versions. The stage sizes are fixed by `STAGES`
(512 centres with kNN-32, 128 with kNN-64), so the clouds keep N=1024.

The JAX XLA path takes the matmul form of the squared distance in both
the kNN and the KDE; the port the subtract form. A near-tie neighbour can
therefore differ (the tests first assert that the kNN indices agree on
their clouds), and the KDE terms differ by the matmul form's cancellation
(~1e-6 absolute in the distance).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu.attacks import base as JB
from hitadv_tpu.attacks import hit_adv as JH
from hitadv_tpu.data import synthetic_clouds
from hitadv_tpu.models import pointconv as JPC
from hitadv_tpu.nn import functional as jnnF
from hitadv_tpu.ops import geometry as JG
from hitadv_torch.attacks import base as B
from hitadv_torch.attacks import hit_adv as H
from hitadv_torch.convert import params_from_numpy
from hitadv_torch.models import PointConv, get_model
from hitadv_torch.models import pointconv as PC
from hitadv_torch.nn import functional as F
from hitadv_torch.ops import geometry as G
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_pointnet2 import random_bn

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


@pytest.fixture(scope="module")
def tree():
    return random_bn(jax.tree_util.tree_map(
        np.asarray, JPC.init(jax.random.PRNGKey(13), num_classes=10)))


@pytest.fixture(scope="module")
def jax_value_and_grad(tree):
    """The JAX logits and the gradient of ``sum(logits * w)``, jitted once
    for the module (f32)."""
    def loss(x, w):
        lg = JPC.apply(tree, x)
        return jnp.sum(lg.astype(jnp.float32) * w), lg

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True))

    def run(x, w):
        (_, lg), g = fn(jnp.asarray(x), jnp.asarray(w))
        return np.asarray(lg.astype(jnp.float32)), np.asarray(g)
    return run


def _model(tree, **kw):
    return PointConv(params=params_from_numpy(tree, "cpu"), device="cpu",
                     **kw)


def _cloud(Bn, seed, N=1024):
    return np.random.RandomState(seed).randn(Bn, N, 3).astype(np.float32) * .5


def knn_indices(geo, xyz):
    """The two sampled stages' kNN indices through ``geo`` (either
    package's geometry module): FPS from index 0, the centre gather, the
    kNN, as the stages run them."""
    out = []
    for stage in PC.STAGES[:2]:
        new_xyz = geo.index_points(xyz, geo.farthest_point_sample(
            xyz, stage.npoint))
        out.append(np.asarray(geo.knn_point(stage.nsample, xyz, new_xyz)))
        xyz = new_xyz
    return out


def test_get_model_and_params(tree):
    assert get_model("pointconv") is PointConv
    m = _model(tree)
    assert m.num_classes == 10 and not m.training
    assert not any(p.requires_grad for p in m.parameters())
    # every stage's DensityNet is positive on the whole of (0, 1], so every
    # stage's output depends on the cloud
    r = torch.linspace(0.01, 1.0, 100)[:, None]
    for i in (1, 2, 3):
        assert (F.mlp_apply(m.params[f"sa{i}"]["densitynet"], r) > 0).all()


def test_fresh_init_has_the_reference_tree_and_is_seeded():
    jtree = JPC.init(jax.random.PRNGKey(0), num_classes=40)
    a = PointConv(40, device="cpu", generator=torch.Generator().manual_seed(3))
    b = PointConv(40, device="cpu", generator=torch.Generator().manual_seed(3))
    leaves = jax.tree_util.tree_leaves_with_path(jtree)
    assert len(leaves) == len(a.state_dict())
    for path, v in leaves:
        t = a.params
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == v.shape, path
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PointConv(10)


@pytest.mark.parametrize("seed", [1, 2])
def test_logits_and_input_grad_f32(tree, jax_value_and_grad, seed):
    x = _cloud(2, seed)
    # matmul against subtract distances: a near-tie neighbour could differ;
    # on these clouds the indices agree (a third cloud tried, seed 3, had
    # one index of 32768 + 16384 differ)
    for want, got in zip(knn_indices(JG, jnp.asarray(x)),
                         knn_indices(G, torch.from_numpy(x))):
        np.testing.assert_array_equal(got, want)
    w = np.random.RandomState(seed).randn(2, 10).astype(np.float32)
    want_lg, want_g = jax_value_and_grad(x, w)
    xt = torch.tensor(x, requires_grad=True)
    lg = _model(tree)(xt)
    (lg * torch.from_numpy(w)).sum().backward()
    # f32 on both sides, the same groups; the KDE's distance forms differ
    # (~1e-6 in a distance) and sums run in other orders. Read: logits
    # 3.1e-7 of their largest, gradient 4.1e-6 relative L2 and 1.6e-5 of
    # its largest element
    np.testing.assert_allclose(lg.detach().numpy(), want_lg, rtol=1e-4,
                               atol=1e-5)
    g = xt.grad.numpy()
    assert np.linalg.norm(g - want_g) <= 1e-4 * np.linalg.norm(want_g)
    np.testing.assert_allclose(g, want_g, rtol=1e-3,
                               atol=1e-4 * np.abs(want_g).max())


def test_logits_bf16(tree):
    x = _cloud(2, 4)
    jnnF.set_compute_dtype(jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v: JPC.apply(tree, v))(
        jnp.asarray(x)).astype(jnp.float32))
    got = _model(tree, compute_dtype=torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    # bf16 activations, rounded at other places by XLA's fusions and by
    # PyTorch's op-by-op execution. Read: 4.9e-4 against logits of at most
    # 0.19
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-3)
    np.testing.assert_array_equal(got.float().numpy().argmax(-1),
                                  want.argmax(-1))


def _grouped_stage(p, stage, xyz, points):
    """One stage in the reference's gather-then-slice formulation
    (`util/pointconv_util.py:334-401`; the JAX package's
    `tests/test_project_then_gather.py`): gather ``[xyz | inverse
    density | features]``, subtract the centre from the xyz slice, the
    full stage MLP and WeightNet on the grouped tensors."""
    B, N, _ = xyz.shape
    inv_density = 1.0 / G.kde_density(xyz, stage.bandwidth)
    if stage.group_all:
        new_xyz = torch.mean(xyz, dim=1, keepdim=True)
        grouped_xyz = xyz[:, None] - new_xyz[:, :, None]
        parts = (grouped_xyz, points[:, None])
        grouped_density = inv_density.reshape(B, 1, N)
    else:
        new_xyz = G.index_points(xyz, G.farthest_point_sample(
            xyz, stage.npoint))
        idx = G.knn_point(stage.nsample, xyz, new_xyz)
        aug = torch.cat([xyz, inv_density[..., None], points], dim=-1)
        grouped = G.index_points(aug, idx)
        grouped_xyz = grouped[..., :3] - new_xyz[:, :, None, :]
        grouped_density = grouped[..., 3]
        parts = (grouped_xyz, grouped[..., 4:])
    h = F.mlp_apply(p["mlp"], parts)
    inv_max = torch.amax(grouped_density, dim=-1, keepdim=True)
    h = h * F.mlp_apply(p["densitynet"],
                        (grouped_density / inv_max)[..., None])
    weights = F.mlp_apply(p["weightnet"], grouped_xyz)
    agg = torch.einsum("bsnc,bsnw->bscw", h, weights)
    agg = agg.reshape(B, new_xyz.shape[1], -1)
    return new_xyz, F.relu(F.linear_bn(p["linear"], p["bn_linear"], agg))


def test_project_then_gather_matches_grouped_formulation(tree):
    """The port's eval stages against the reference's grouped formulation
    at the JAX package's tolerance (`tests/test_project_then_gather.py`:
    5e-6 on the logits, 1e-3 relative L2 on the input gradient)."""
    m = _model(tree)
    p = m.params
    x = _cloud(2, 5)
    xt = torch.tensor(x, requires_grad=True)
    fused = m(xt)
    fused.sum().backward()
    xr = torch.tensor(x, requires_grad=True)
    xyz, h = xr, xr
    for i, stage in enumerate(PC.STAGES, start=1):
        xyz, h = _grouped_stage(p[f"sa{i}"], stage, xyz, h)
    g = F.relu(F.linear_bn(p["fc1"], p["bn1"], h[:, 0]))
    g = F.relu(F.linear_bn(p["fc2"], p["bn2"], g))
    ref = F.linear(p["fc3"], g)
    ref.sum().backward()
    assert (fused - ref).abs().max().item() < 5e-6
    rel = (xt.grad - xr.grad).norm() / xr.grad.norm()
    assert rel.item() < 1e-3


def _overrides(seed, S, Bn, Cn, budget):
    d = np.random.RandomState(seed)
    return {"pert": (d.rand(S, Bn, Cn, 3) * budget).astype(np.float32),
            "delta": (0.1 + d.rand(S, Bn, Cn) * 1.1).astype(np.float32)}


def test_pinned_draw_hit_adv_against_pointconv(tree):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jfn = jax.jit(lambda x: JPC.apply(params, x))
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
    # f32 on both sides in other op orders, ~1e-7 per iteration, which
    # Adam's normalised steps can amplify. Read: 1.2e-7
    np.testing.assert_allclose(got.adv_points.numpy(),
                               np.asarray(want.adv_points), atol=1e-5)
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))
