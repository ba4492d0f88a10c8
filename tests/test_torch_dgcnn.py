"""The port's DGCNN against `hitadv_tpu.models.dgcnn`, and HiT-ADV against
it.

One numpy parameter tree (the JAX init at a narrow embedding, with random
BN statistics so that the fold is exercised) feeds both packages through
`params_from_numpy`. The JAX side runs its plain XLA path; the port runs
on the CPU, where its kernels take their plain versions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu.attacks import base as JB
from hitadv_tpu.attacks import hit_adv as JH
from hitadv_tpu.data import synthetic_clouds
from hitadv_tpu.models import dgcnn as JD
from hitadv_tpu.nn import functional as jnnF
from hitadv_tpu.ops import geometry as JG
from hitadv_torch.attacks import base as B
from hitadv_torch.attacks import hit_adv as H
from hitadv_torch.convert import params_from_numpy
from hitadv_torch.models import DGCNN, DGCNNConfig, get_model
from hitadv_torch.models import dgcnn as D
from test_torch_kernels import one_torch_thread  # noqa: F401

SMALL_CFG = dict(k=20, emb_dims=64)
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
    params = jax.tree_util.tree_map(
        np.asarray, JD.init(jax.random.PRNGKey(3), num_classes=10,
                            cfg=JD.DGCNNConfig(**SMALL_CFG)))
    rng = np.random.RandomState(0)
    for name, node in params.items():
        if name.startswith("bn"):           # non-trivial statistics
            c = node["var"].shape[0]
            node.update(scale=1 + 0.2 * rng.randn(c).astype(np.float32),
                        bias=0.1 * rng.randn(c).astype(np.float32),
                        mean=0.1 * rng.randn(c).astype(np.float32),
                        var=(0.5 + rng.rand(c)).astype(np.float32))
    return params


def _jax_apply(cfg=SMALL_CFG):
    return JD.make_apply(JD.DGCNNConfig(**cfg))


def _model(tree, cfg=SMALL_CFG, **kw):
    return DGCNN(params=params_from_numpy(tree, "cpu"), device="cpu",
                 cfg=DGCNNConfig(**cfg), **kw)


def _cloud(B, N, seed=1):
    return np.random.RandomState(seed).randn(B, N, 3).astype(np.float32) * 0.5


def _jax_logits_and_grad(tree, x, w, cfg=SMALL_CFG):
    apply = _jax_apply(cfg)

    def loss(x):
        lg = apply(tree, x)
        return jnp.sum(lg.astype(jnp.float32) * w), lg

    (_, lg), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(x))
    return np.asarray(lg.astype(jnp.float32)), np.asarray(g)


def _torch_logits_and_grad(model, x, w):
    xt = torch.tensor(x, requires_grad=True)
    lg = model(xt)
    (lg.float() * torch.from_numpy(w)).sum().backward()
    return lg.detach().float().numpy(), xt.grad.numpy()


def test_get_model_and_params(tree):
    assert get_model("dgcnn") is DGCNN
    m = _model(tree)
    assert m.num_classes == 10 and m.emb_dims == 64 and m.k == 20
    assert not m.training
    assert not any(p.requires_grad for p in m.parameters())


def test_fresh_init_has_the_reference_tree_and_is_seeded():
    jtree = JD.init(jax.random.PRNGKey(0), num_classes=40)
    a = DGCNN(40, device="cpu", generator=torch.Generator().manual_seed(3))
    b = DGCNN(40, device="cpu", generator=torch.Generator().manual_seed(3))
    for name, node in jtree.items():
        for leaf, v in node.items():
            assert tuple(a.params[name][leaf].shape) == v.shape, (name, leaf)
        assert set(a.params[name]) == set(node), name
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DGCNN(10)


@pytest.mark.parametrize("seed", [1, 2])
def test_logits_and_input_grad_f32(tree, seed):
    x = _cloud(2, 128, seed=seed)
    w = np.random.RandomState(2).randn(2, 10).astype(np.float32)
    want_lg, want_g = _jax_logits_and_grad(tree, x, w)
    got_lg, got_g = _torch_logits_and_grad(_model(tree), x, w)
    # f32 on both sides: the same neighbour graphs (the JAX kNN takes
    # the matmul distance, the port the elementwise one; no near-tie
    # flips at this seed), sums in other orders: ~1e-6 relative per layer
    np.testing.assert_allclose(got_lg, want_lg, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-3, atol=1e-5)


def test_logits_and_input_grad_f32_at_k65(tree):
    """``--k`` past 64 (the card's kNN then selects in passes of 64):
    DGCNN at k = 65 on 128 points against the JAX DGCNN at the same k,
    as `test_logits_and_input_grad_f32` does at k = 20."""
    cfg = dict(SMALL_CFG, k=65)
    x = _cloud(2, 128, seed=1)
    w = np.random.RandomState(2).randn(2, 10).astype(np.float32)
    want_lg, want_g = _jax_logits_and_grad(tree, x, w, cfg)
    got_lg, got_g = _torch_logits_and_grad(_model(tree, cfg), x, w)
    np.testing.assert_allclose(got_lg, want_lg, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-3, atol=1e-5)


def test_edge_conv_fused_matches(tree):
    h = np.random.RandomState(4).randn(2, 100, 64).astype(np.float32)
    want = JD.edge_conv_fused(tree["conv2"], tree["bn2"], jnp.asarray(h), 20)
    tp = params_from_numpy(tree, "cpu")
    got = D.edge_conv_fused(tp["conv2"], tp["bn2"], torch.from_numpy(h), 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_logits_bf16(tree):
    x = _cloud(4, 128, seed=3)
    w = np.zeros((4, 10), np.float32)
    jnnF.set_compute_dtype(jnp.bfloat16)
    want_lg, _ = _jax_logits_and_grad(tree, x, w)
    got_lg, _ = _torch_logits_and_grad(
        _model(tree, compute_dtype=torch.bfloat16), x, w)
    # bf16 activations; the JAX kNN squares bf16 features in bf16, the
    # port widens them to f32 first, so near-tie neighbours can differ:
    # a few bf16 ulps of the logits
    np.testing.assert_allclose(got_lg, want_lg, atol=6e-2)
    np.testing.assert_array_equal(got_lg.argmax(-1), want_lg.argmax(-1))


def _overrides(seed, S, Bn, Cn, budget):
    d = np.random.RandomState(seed)
    return {"pert": (d.rand(S, Bn, Cn, 3) * budget).astype(np.float32),
            "delta": (0.1 + d.rand(S, Bn, Cn) * 1.1).astype(np.float32)}


def test_pinned_draw_hit_adv_against_dgcnn(tree):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    apply = _jax_apply()
    jfn = jax.jit(lambda x: apply(params, x))
    model = _model(tree)
    pts, _ = synthetic_clouds(3, 128, num_classes=10, seed=6)
    labels = np.array(jnp.argmax(jfn(jnp.asarray(pts[..., :3])), -1),
                      np.int32)
    ov = _overrides(12, SMALL_ATTACK["binary_step"], 3,
                    SMALL_ATTACK["central_num"], 0.55)
    want = JH.make_hit_adv(jfn, JB.make_adv_fn("logits", kappa=30.0),
                           JH.HiTADVConfig(**SMALL_ATTACK),
                           init_overrides=ov)(
        jnp.asarray(pts), jnp.asarray(labels), jax.random.PRNGKey(0))
    got = H.make_hit_adv(model, B.make_adv_fn("logits", kappa=30.0),
                         H.HiTADVConfig(**SMALL_ATTACK), init_overrides=ov,
                         device="cpu")(pts, labels)
    # f32 on both sides in other op orders, as for PointNet
    # (tests/test_torch_hit_adv.py): ~1e-6 per iteration, amplified by
    # Adam's normalised steps
    np.testing.assert_allclose(got.adv_points.numpy(),
                               np.asarray(want.adv_points), atol=2e-3)
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))
