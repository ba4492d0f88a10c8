"""The port's PCT against `hitadv_tpu.models.pct`.

Numpy parameter trees from the JAX init feed both packages through
`params_from_numpy`. The JAX side runs its plain XLA path; the port runs
on the CPU, where its kernels take their plain versions. The stage sizes
are fixed by `pct.apply` (512 and 256 centres), so the clouds keep
N=1024.

The gradient of a randomly initialised PCT is ill-conditioned where the
BN statistics are random: the port's own input gradient moved by 0.5-0.6%
of its norm when the cloud was scaled by 1 + 1e-7, at the two clouds
tried (ties and near ties of the neighbour maxima, spread by the
attention). The logits are
compared on such a tree, which exercises the BN folds; the input
gradient on the JAX init's tree (unit BN statistics) at a cloud where
that perturbation moved it by 4e-7, and layer by layer on the random
tree.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu.models import pct as JC
from hitadv_tpu.nn import functional as jnnF
from hitadv_tpu.ops import geometry as JG
from hitadv_torch.convert import params_from_numpy
from hitadv_torch.models import PCT, get_model
from hitadv_torch.models import pct as C
from hitadv_torch.nn import functional as F
from hitadv_torch.ops import geometry as G
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_pointnet2 import random_bn


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


def _init_tree():
    return jax.tree_util.tree_map(
        np.asarray, JC.init(jax.random.PRNGKey(0), num_classes=10))


@pytest.fixture(scope="module")
def tree():
    """Random BN statistics: the folds are exercised."""
    return random_bn(_init_tree())


@pytest.fixture(scope="module")
def unit_bn_tree():
    return _init_tree()


def _jit_value_and_grad(tree):
    def loss(x, w):
        lg = JC.apply(tree, x)
        return jnp.sum(lg.astype(jnp.float32) * w), lg

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _model(tree, **kw):
    return PCT(params=params_from_numpy(tree, "cpu"), device="cpu", **kw)


def _cloud(Bn, seed, N=1024):
    return np.random.RandomState(seed).randn(Bn, N, 3).astype(np.float32) * .5


def knn_indices(geo, xyz):
    """Both grouping stages' kNN-32 indices through ``geo`` (either
    package's geometry module), as `pct.apply` takes them."""
    out = []
    for npoint in (512, 256):
        new_xyz = geo.index_points(xyz, geo.farthest_point_sample(xyz,
                                                                  npoint))
        out.append(np.asarray(geo.knn_point(32, xyz, new_xyz)))
        xyz = new_xyz
    return out


def _logits_and_grad(tree, x, w, **kw):
    xt = torch.tensor(x, requires_grad=True)
    lg = _model(tree, **kw)(xt)
    (lg.float() * torch.from_numpy(w)).sum().backward()
    return lg.detach().float().numpy(), xt.grad.numpy()


def test_get_model_and_tied_qk(tree):
    assert get_model("pct") is PCT
    m = _model(tree)
    assert m.num_classes == 10 and not m.training
    assert not any(p.requires_grad for p in m.parameters())
    # q and k load from the one tied tensor of the JAX tree
    for i in range(1, 5):
        assert set(m.params[f"sa{i}"]) == {"qk_conv", "v_conv", "trans_conv",
                                           "after_norm"}
        np.testing.assert_array_equal(
            m.params[f"sa{i}"]["qk_conv"]["w"].numpy(),
            tree[f"sa{i}"]["qk_conv"]["w"])


def test_fresh_init_has_the_reference_tree_and_is_seeded():
    jtree = JC.init(jax.random.PRNGKey(0), num_classes=40)
    a = PCT(40, device="cpu", generator=torch.Generator().manual_seed(3))
    b = PCT(40, device="cpu", generator=torch.Generator().manual_seed(3))
    for path, v in jax.tree_util.tree_leaves_with_path(jtree):
        t = a.params
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == v.shape, path
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PCT(10)


@pytest.mark.parametrize("seed", [1, 4])
def test_logits_f32(tree, seed):
    x = _cloud(2, seed)
    # the JAX XLA kNN takes the matmul form of the distance, the port the
    # elementwise one, so near-tie neighbours could differ; at these seeds
    # the indices agree
    for want, got in zip(knn_indices(JG, jnp.asarray(x)),
                         knn_indices(G, torch.from_numpy(x))):
        np.testing.assert_array_equal(got, want)
    w = np.zeros((2, 10), np.float32)
    (_, want), _ = _jit_value_and_grad(tree)(jnp.asarray(x), jnp.asarray(w))
    got, _ = _logits_and_grad(tree, x, w)
    # f32 on both sides, the same groups; sums in other orders
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_input_grad_f32(unit_bn_tree):
    x = _cloud(2, 2)
    for want, got in zip(knn_indices(JG, jnp.asarray(x)),
                         knn_indices(G, torch.from_numpy(x))):
        np.testing.assert_array_equal(got, want)
    w = np.random.RandomState(2).randn(2, 10).astype(np.float32)
    (_, want_lg), want_g = _jit_value_and_grad(unit_bn_tree)(
        jnp.asarray(x), jnp.asarray(w))
    got_lg, got_g = _logits_and_grad(unit_bn_tree, x, w)
    np.testing.assert_allclose(got_lg, np.asarray(want_lg), rtol=1e-4,
                               atol=1e-5)
    # a well-conditioned point (see the module docstring): the f32
    # rounding of both sides, amplified by the attention
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-3,
                               atol=1e-4 * np.abs(want_g).max())


def test_layers_values_and_grads(tree):
    """The offset attention and the fused Local_op, value and input
    gradient, on the random-BN tree: tight, as no max near-tie is met."""
    rng = np.random.RandomState(0)
    tp = params_from_numpy(tree, "cpu")
    x = rng.randn(2, 256, 256).astype(np.float32)
    w = rng.randn(2, 256, 256).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda v: jnp.sum(
        JC._sa_layer_apply(tree["sa1"], v) * w))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    v = (C._sa_layer_apply(tp["sa1"], xt) * torch.from_numpy(w)).sum()
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)

    pts = rng.randn(2, 1024, 64).astype(np.float32)
    fps = rng.randint(0, 1024, (2, 512)).astype(np.int32)
    idx = rng.randint(0, 1024, (2, 512, 32)).astype(np.int32)
    w2 = rng.randn(2, 512, 128).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda p: jnp.sum(JC._local_op_fused(
        tree["gather0"], p, jnp.asarray(fps), jnp.asarray(idx)) * w2))(
        jnp.asarray(pts))
    pt = torch.tensor(pts, requires_grad=True)
    v = (C._local_op_fused(tp["gather0"], pt, torch.from_numpy(fps),
                           torch.from_numpy(idx)) * torch.from_numpy(w2)).sum()
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)


def test_logits_bf16(tree):
    x = _cloud(2, 4)
    jnnF.set_compute_dtype(jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v: JC.apply(tree, v))(
        jnp.asarray(x)).astype(jnp.float32))
    got = _model(tree, compute_dtype=torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    # bf16 activations rounded at other places by the two frameworks (the
    # class of the DGCNN test)
    np.testing.assert_allclose(got.float().numpy(), want, atol=6e-2)
    np.testing.assert_array_equal(got.float().numpy().argmax(-1),
                                  want.argmax(-1))


def test_project_then_gather_matches_grouped_formulation(tree):
    """`_local_op_fused` against the reference's grouped formulation
    (`model/pct_utils.py:111-141`: `sample_and_group_knn`, conv1 on the
    concat, conv2, the max over the group axis), at the tolerance of the
    JAX package's test (`tests/test_project_then_gather.py`)."""
    p = params_from_numpy(tree, "cpu")["gather0"]
    x = torch.from_numpy(_cloud(2, 5))
    h = torch.from_numpy(np.random.RandomState(6).randn(2, 1024, 64).astype(
        np.float32))
    fps_idx = G.farthest_point_sample(x, 512)
    idx = G.knn_point(32, x, G.index_points(x, fps_idx))
    fused = C._local_op_fused(p, h, fps_idx, idx)
    _, grouped = G.sample_and_group_knn(512, 32, x, h)
    assert grouped.shape == (2, 512, 32, 128)
    ref = F.max_mid(F.mlp_apply(p_as_mlp(p), grouped))
    assert (fused - ref).abs().max().item() < 5e-6
    _, parts = G.sample_and_group_knn(512, 32, x, h, concat=False)
    split = F.max_mid(F.mlp_apply(p_as_mlp(p), parts))
    assert (split - ref).abs().max().item() < 5e-6


def p_as_mlp(p):
    """A Local_op's conv1/bn1/conv2/bn2 as an `mlp_apply` stack."""
    return {"conv0": p["conv1"], "bn0": p["bn1"], "conv1": p["conv2"],
            "bn1": p["bn2"]}
