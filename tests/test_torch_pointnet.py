"""The port's PointNet against `hitadv_tpu.models.pointnet.apply`.

One numpy parameter tree (the JAX init, with random BN statistics so the
fold is exercised) feeds both packages through `params_from_numpy`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu.models import pointnet as JP
from hitadv_tpu.nn import functional as jnnF
from hitadv_tpu.ops import geometry as JG
from hitadv_torch.convert import params_from_numpy
from hitadv_torch.models import PointNet, get_model
from test_torch_kernels import one_torch_thread  # noqa: F401


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
    params = jax.tree_util.tree_map(np.asarray,
                                    JP.init(jax.random.PRNGKey(7)))
    rng = np.random.RandomState(0)

    def jitter(node):
        if "var" in node:                   # a BN: non-trivial statistics
            c = node["var"].shape[0]
            node.update(scale=1 + 0.2 * rng.randn(c).astype(np.float32),
                        bias=0.1 * rng.randn(c).astype(np.float32),
                        mean=0.1 * rng.randn(c).astype(np.float32),
                        var=(0.5 + rng.rand(c)).astype(np.float32))
            return
        for v in node.values():
            if isinstance(v, dict):
                jitter(v)

    jitter(params)
    return params


def _cloud(B, N, seed=1):
    return np.random.RandomState(seed).randn(B, N, 3).astype(np.float32) * 0.5


def _jax_logits_and_grad(tree, x, w):
    def loss(params, x):
        lg = JP.apply(params, x)
        return jnp.sum(lg.astype(jnp.float32) * w), lg

    (_, lg), g = jax.jit(jax.value_and_grad(loss, argnums=1, has_aux=True))(
        tree, jnp.asarray(x))
    return np.asarray(lg.astype(jnp.float32)), np.asarray(g)


def _torch_logits_and_grad(model, x, w):
    xt = torch.tensor(x, requires_grad=True)
    lg = model(xt)
    (lg.float() * torch.from_numpy(w)).sum().backward()
    return lg.detach().float().numpy(), xt.grad.numpy()


def test_get_model_and_defaults(tree):
    assert get_model("pointnet") is PointNet
    m = PointNet(params=params_from_numpy(tree, "cpu"), device="cpu")
    assert m.num_classes == 40 and not m.training
    assert not any(p.requires_grad for p in m.parameters())


@pytest.mark.parametrize("N", [100, 130])
def test_logits_and_input_grad_f32(tree, N):
    x = _cloud(2, N)
    w = np.random.RandomState(2).randn(2, 40).astype(np.float32)
    want_lg, want_g = _jax_logits_and_grad(tree, x, w)
    model = PointNet(params=params_from_numpy(tree, "cpu"), device="cpu")
    got_lg, got_g = _torch_logits_and_grad(model, x, w)
    # f32 on both sides, sums in other orders: ~1e-6 relative per layer
    np.testing.assert_allclose(got_lg, want_lg, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-4, atol=1e-5)


def test_logits_bf16(tree):
    x = _cloud(4, 100, seed=3)
    w = np.zeros((4, 40), np.float32)
    jnnF.set_compute_dtype(jnp.bfloat16)
    want_lg, _ = _jax_logits_and_grad(tree, x, w)
    model = PointNet(params=params_from_numpy(tree, "cpu"), device="cpu",
                     compute_dtype=torch.bfloat16)
    got_lg, _ = _torch_logits_and_grad(model, x, w)
    # bf16 activations round at other places in the two programs (the
    # JAX plain path rounds the conv3 output before its max; the fused
    # max-pool keeps f32): ~1e-2
    np.testing.assert_allclose(got_lg, want_lg, atol=2e-2)
    np.testing.assert_array_equal(got_lg.argmax(-1), want_lg.argmax(-1))


def test_input_grad_against_fused_pallas_backward(tree):
    """With the JAX side on its Pallas path (interpret mode), its
    max-pool backward routes each column to the first argmax row — the
    kernel semantics the port's max-linear backward implements."""
    JG.set_backend("pallas")
    x = _cloud(2, 32, seed=4)
    w = np.random.RandomState(5).randn(2, 40).astype(np.float32)
    want_lg, want_g = _jax_logits_and_grad(tree, x, w)
    model = PointNet(params=params_from_numpy(tree, "cpu"), device="cpu")
    got_lg, got_g = _torch_logits_and_grad(model, x, w)
    np.testing.assert_allclose(got_lg, want_lg, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-4, atol=1e-5)


def test_feature_taps_match(tree):
    x = _cloud(2, 64, seed=6)
    want = jax.jit(JP.apply_full)(tree, jnp.asarray(x))
    model = PointNet(params=params_from_numpy(tree, "cpu"), device="cpu")
    got = model.apply_full(torch.from_numpy(x))
    assert len(got.features) == len(want.features) == 8
    for a, b in zip(got.features, want.features):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(got.trans_feat.numpy(),
                               np.asarray(want.trans_feat), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=1e-5, atol=1e-5)


def test_fresh_init_is_seeded_and_cuda_by_default():
    a = PointNet(10, device="cpu", generator=torch.Generator().manual_seed(3))
    b = PointNet(10, device="cpu", generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PointNet(10)


def test_max_pool_weight_grads_match_pallas_vjp():
    """dW and db of the fused max-pool (skipped by frozen victims) against
    the JAX custom VJP of the Pallas pair."""
    from hitadv_torch.nn import functional as F

    rng = np.random.RandomState(8)
    x = rng.randn(2, 40, 16).astype(np.float32)
    w = rng.randn(16, 24).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    gw = rng.randn(2, 24).astype(np.float32)
    JG.set_backend("pallas")
    _, vjp = jax.vjp(jnnF._max_linear_fused, jnp.asarray(x), jnp.asarray(w),
                     jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(gw))
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    (F._MaxLinear.apply(xt, wt, bt) * torch.from_numpy(gw)).sum().backward()
    for got, want in [(xt.grad, jdx), (wt.grad, jdw), (bt.grad, jdb)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_normal_channel_input_matches():
    """6-channel input: the transform applies to xyz only, then conv1 sees
    the concatenation."""
    tree = jax.tree_util.tree_map(np.asarray, JP.init(
        jax.random.PRNGKey(9), num_classes=10, normal_channel=True))
    x = np.random.RandomState(10).randn(2, 48, 6).astype(np.float32)
    want = jax.jit(JP.apply)(tree, jnp.asarray(x))
    model = PointNet(params=params_from_numpy(tree, "cpu"), device="cpu")
    assert model.num_classes == 10
    np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_linear_and_linear_parts(bf16):
    from hitadv_torch.nn import functional as F

    rng = np.random.RandomState(11)
    p = {"w": rng.randn(7, 5).astype(np.float32),
         "b": rng.randn(5).astype(np.float32)}
    a = rng.randn(2, 9, 3).astype(np.float32)
    c = rng.randn(2, 9, 4).astype(np.float32)
    if bf16:
        jnnF.set_compute_dtype(jnp.bfloat16)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    want_parts = jnnF.linear(jp, (jnp.asarray(a), jnp.asarray(c)))
    want_full = jnnF.linear(jp, jnp.concatenate([a, c], -1))
    cd = torch.bfloat16 if bf16 else None
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got_parts = F.linear(tp, (torch.from_numpy(a), torch.from_numpy(c)), cd)
    got_full = F.linear(tp, torch.from_numpy(np.concatenate([a, c], -1)), cd)
    tol = 2e-2 if bf16 else 1e-5
    for got, want in [(got_parts, want_parts), (got_full, want_full)]:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="parts supply"):
        F.linear(tp, (torch.from_numpy(a),), cd)
