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


# ---------------------------------------------------------------------------
# MSG set abstraction and feature propagation (`msg_apply`, `fp_apply`)
# ---------------------------------------------------------------------------

MSG = dict(npoint=32, radius_list=[0.2, 0.4], nsample_list=[8, 16])
MSG_MLPS = [[32, 32], [32, 64]]


def _msg_tree(in_channel, key=5):
    return random_bn(jax.tree_util.tree_map(np.asarray, JP.msg_init(
        jax.random.PRNGKey(key), in_channel, MSG_MLPS)), seed=key)


def _fp_tree(in_channel, mlp, key=6):
    return random_bn(jax.tree_util.tree_map(np.asarray, JP.fp_init(
        jax.random.PRNGKey(key), in_channel, mlp)), seed=key)


def _msg_inputs(seed, D):
    rng = np.random.RandomState(seed)
    xyz = rng.rand(2, 128, 3).astype(np.float32)
    feats = rng.randn(2, 128, D).astype(np.float32) if D else None
    return xyz, feats


def msg_ball_indices(geo, xyz):
    """Each branch's ball-query indices through ``geo`` (either package's
    geometry module), FPS from index 0, as `msg_apply` runs them."""
    new_xyz = geo.index_points(xyz, geo.farthest_point_sample(
        xyz, MSG["npoint"]))
    return [np.asarray(geo.query_ball_point(r, ns, xyz, new_xyz))
            for r, ns in zip(MSG["radius_list"], MSG["nsample_list"])]


def three_nn_indices(xyz1, xyz2):
    """(JAX's 3-NN indices as its `fp_apply` takes them, the port's)."""
    _, jidx = jax.lax.top_k(-JG.square_distance(jnp.asarray(xyz1),
                                                jnp.asarray(xyz2)), 3)
    return np.asarray(jidx), G.knn_points(torch.from_numpy(xyz1),
                                          torch.from_numpy(xyz2),
                                          3).idx.numpy()


def _value_and_grads(jfn, fn, arrays, g):
    """``jfn`` (JAX) and ``fn`` (the port) on the same numpy ``arrays``
    (None passes through): the outputs and the gradients of ``sum(out *
    g)`` to every array."""
    live = [i for i, a in enumerate(arrays) if a is not None]

    def jloss(*xs):
        args = list(arrays)
        for i, x in zip(live, xs):
            args[i] = x
        out = jfn(*args)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(live))), has_aux=True)(
            *[jnp.asarray(arrays[i]) for i in live])
    ts = [None if a is None else torch.tensor(a, requires_grad=True)
          for a in arrays]
    out = fn(*ts)
    # an input the output does not depend on (FP's clouds at S == 1)
    # takes a zero gradient, as JAX gives it
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                [ts[i] for i in live], allow_unused=True)
    return (np.asarray(jout), [np.asarray(x) for x in jgrads],
            out.detach().numpy(),
            [np.zeros_like(arrays[i]) if x is None else x.numpy()
             for i, x in zip(live, grads)])


@pytest.mark.parametrize("D", [16, 0])
def test_msg_apply_values_and_grads(D):
    """`msg_apply` with and without features against JAX's on one tree
    (random BN statistics): ball-query indices equal first, then the
    centres, the features, and the gradients to the cloud and to the
    features."""
    tree = _msg_tree(D)
    xyz, feats = _msg_inputs(7, D)
    for want, got in zip(msg_ball_indices(JG, jnp.asarray(xyz)),
                         msg_ball_indices(G, torch.from_numpy(xyz))):
        np.testing.assert_array_equal(got, want)
    params = params_from_numpy(tree, "cpu")
    g = np.random.RandomState(8).randn(2, 32, 96).astype(np.float32)
    want_xyz, _ = JP.msg_apply(tree, xyz=jnp.asarray(xyz), points=None
                               if feats is None else jnp.asarray(feats),
                               **MSG)
    got_xyz, _ = P.msg_apply(params, xyz=torch.from_numpy(xyz), points=None
                             if feats is None else torch.from_numpy(feats),
                             **MSG)
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    want, want_g, got, got_g = _value_and_grads(
        lambda x, f: JP.msg_apply(tree, xyz=x, points=f, **MSG)[1],
        lambda x, f: P.msg_apply(params, xyz=x, points=f, **MSG)[1],
        [xyz, feats], g)
    assert got.shape == (2, 32, 96)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)


def test_msg_init_has_the_jax_tree():
    """`msg_init` and `fp_init`: the JAX package's paths and shapes, each
    branch ``in_channel + 3`` wide."""
    jtree = JP.msg_init(jax.random.PRNGKey(0), 16, MSG_MLPS)
    tree = P.msg_init(16, MSG_MLPS, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    assert tree["branch0"]["conv0"]["w"].shape == (19, 32)
    jfp = JP.fp_init(jax.random.PRNGKey(0), 24, [32, 16])
    fp = P.fp_init(24, [32, 16], generator=torch.Generator().manual_seed(0),
                   device="cpu")
    for j, t in ((jtree, tree), (jfp, fp)):
        want = {tuple(k.key for k in path): v.shape for path, v in
                jax.tree_util.tree_leaves_with_path(j)}
        got = {}

        def walk(node, path=()):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    got[path + (k,)] = tuple(v.shape)
        walk(t)
        assert got == want


def test_msg_start_from_a_generator_is_seeded():
    """A generator as `msg_apply`'s FPS start: each cloud's start drawn
    from it, the same twice from the same seed."""
    params = params_from_numpy(_msg_tree(0), "cpu")
    xyz = torch.from_numpy(_msg_inputs(9, 0)[0])

    def run():
        return P.msg_apply(params, xyz=xyz, points=None, **MSG,
                           start=torch.Generator().manual_seed(11))

    (a_xyz, a), (b_xyz, b) = run(), run()
    assert torch.equal(a_xyz, b_xyz) and torch.equal(a, b)
    start = torch.randint(0, 128, (2,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(11))
    assert torch.equal(a_xyz[:, 0], xyz[torch.arange(2), start.long()])
    fixed = P.msg_apply(params, xyz=xyz, points=None, **MSG, start=start)
    assert torch.equal(fixed[0], a_xyz) and torch.equal(fixed[1], a)


# FP's dense points lie at least this far from every sparse point: the
# weights' gradient grows as 1 / d^2, and JAX's matmul distance form
# carries an absolute error of ~1e-7 (`ROADMAP.md` §3, distance forms),
# so gradients are compared away from d = 0 only
FP_GAP = 0.1


def _fp_inputs(seed, N=64, S=16, D1=8, D2=16):
    """Dense clouds [2, N, 3] in the unit cube, each point at least
    `FP_GAP` from every one of the sparse clouds' S points, and features."""
    rng = np.random.RandomState(seed)
    xyz2 = rng.rand(2, S, 3).astype(np.float32)
    xyz1 = []
    for b in range(2):
        cand = rng.rand(8 * N, 3).astype(np.float32)
        gap = np.linalg.norm(cand[:, None] - xyz2[b][None], axis=-1).min(-1)
        xyz1.append(cand[gap >= FP_GAP][:N])
    return (np.stack(xyz1), xyz2,
            rng.randn(2, N, D1).astype(np.float32) if D1 else None,
            rng.randn(2, S, D2).astype(np.float32))


@pytest.mark.parametrize("S,D1", [(16, 8), (16, 0), (1, 0)])
def test_fp_apply_values_and_grads(S, D1):
    """`fp_apply` with the skip features, without them, and from one
    sparse point (S == 1, broadcast) against JAX's: 3-NN indices equal
    first, then the features and the gradients to both clouds and both
    feature sets. No dense point lies within `FP_GAP` of a sparse one."""
    xyz1, xyz2, p1, p2 = _fp_inputs(12, S=S, D1=D1)
    tree = _fp_tree(D1 + 16, [32, 16])
    params = params_from_numpy(tree, "cpu")
    if S > 1:
        want_idx, got_idx = three_nn_indices(xyz1, xyz2)
        np.testing.assert_array_equal(got_idx, want_idx)
    g = np.random.RandomState(13).randn(2, 64, 16).astype(np.float32)
    want, want_g, got, got_g = _value_and_grads(
        lambda a, b, c, d: JP.fp_apply(tree, a, b, c, d),
        lambda a, b, c, d: P.fp_apply(params, a, b, c, d),
        [xyz1, xyz2, p1, p2], g)
    assert got.shape == (2, 64, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)


def test_fp_known_points_take_their_feature():
    """In real use the sparse points are an FPS subset of the dense ones:
    there each known point's distance to itself is 0 (exactly, in the
    port's elementwise form; a small value of either sign in JAX's
    matmul form), its weight about 1e8, and its interpolated row is its
    own feature within 1e-5 relative in both packages; the MLP's outputs
    agree."""
    rng = np.random.RandomState(14)
    xyz1 = rng.rand(2, 64, 3).astype(np.float32)
    p1 = rng.randn(2, 64, 8).astype(np.float32)
    p2 = rng.randn(2, 16, 16).astype(np.float32)
    sel = np.stack([rng.permutation(64)[:16] for b in range(2)])
    xyz2 = np.stack([xyz1[b, sel[b]] for b in range(2)])
    want_idx, got_idx = three_nn_indices(xyz1, xyz2)
    np.testing.assert_array_equal(got_idx, want_idx)
    d, idx = G.knn_points(torch.from_numpy(xyz1), torch.from_numpy(xyz2), 3)
    got = G.three_interpolate(torch.from_numpy(p2), idx,
                              G.interpolate_weights(d)).numpy()
    jneg, jidx = jax.lax.top_k(-JG.square_distance(jnp.asarray(xyz1),
                                                   jnp.asarray(xyz2)), 3)
    want = np.asarray(JG.three_interpolate(
        jnp.asarray(p2), jidx, JG.interpolate_weights(-jneg)))
    for b in range(2):
        for out in (got, want):
            np.testing.assert_allclose(out[b, sel[b]], p2[b], rtol=1e-5,
                                       atol=1e-5 * np.abs(p2).max())
    tree = _fp_tree(8 + 16, [32, 16])
    jout = JP.fp_apply(tree, *[jnp.asarray(a) for a in (xyz1, xyz2, p1, p2)])
    out = P.fp_apply(params_from_numpy(tree, "cpu"),
                     *[torch.from_numpy(a) for a in (xyz1, xyz2, p1, p2)])
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-5)


def test_msg_fp_bf16():
    """The MSG stage, then FP back to the dense cloud, in bf16 in both
    packages: within the file's bf16 band."""
    msg_tree, fp_tree = _msg_tree(16), _fp_tree(16 + 96, [32, 16])
    xyz, feats = _msg_inputs(16, 16)
    jnnF.set_compute_dtype(jnp.bfloat16)

    def jchain(x, f):
        new_xyz, h = JP.msg_apply(msg_tree, xyz=x, points=f, **MSG)
        return JP.fp_apply(fp_tree, x, new_xyz, f, h)

    want = np.asarray(jax.jit(jchain)(jnp.asarray(xyz), jnp.asarray(feats))
                      .astype(jnp.float32))
    bf = torch.bfloat16
    mp, fp = params_from_numpy(msg_tree, "cpu"), params_from_numpy(fp_tree,
                                                                   "cpu")
    x, f = torch.from_numpy(xyz), torch.from_numpy(feats)
    new_xyz, h = P.msg_apply(mp, xyz=x, points=f, **MSG, compute_dtype=bf)
    assert h.dtype == bf
    got = P.fp_apply(fp, x, new_xyz, f, h, compute_dtype=bf)
    assert got.dtype == bf
    # bf16 activations, rounded at other places by XLA's fusions and by
    # PyTorch's op-by-op execution (the class of the logits test)
    np.testing.assert_allclose(got.float().numpy(), want, atol=6e-2)
