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
from test_torch_kernels import one_torch_thread  # noqa: F401


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
    got = G.farthest_point_sample(_t(x), npoint, start)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_farthest_point_sample_generator_start_is_seeded():
    """A seeded draw of per-cloud starts (the attacks' convention) gives
    the same samples twice, each beginning at its cloud's start."""
    x = _t(_cloud(10, 3, 100))

    def start():
        return torch.randint(0, 100, (3,), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(3))

    a = G.farthest_point_sample(x, 16, start())
    b = G.farthest_point_sample(x, 16, start())
    assert torch.equal(a, b)
    assert torch.equal(a[:, 0], start())
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


@pytest.mark.parametrize("C", [64, 3])
def test_knn_idx_feature_space_equal_indices(C):
    """Self-included neighbour indices, as DGCNN takes them, against the
    reference's `knn_idx` (XLA: matmul distances + top_k)."""
    x = _cloud(15, 2, 128, C)
    want = np.asarray(JG.knn_idx(jnp.asarray(x), jnp.asarray(x), 20))
    xt = _t(x, grad=True)
    got = G.knn_idx(xt, xt, 20)
    assert got.dtype == torch.int32 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[..., 0].numpy() == np.arange(128)).all()   # self first


def test_knn_points_grad_for_the_query_only():
    """adv->ori Chamfer: only the query needs a gradient; the points'
    scatter-add is skipped and the query's gradient is the reference's."""
    q, p = _cloud(16, 2, 100), _cloud(17, 2, 120)
    want = jax.grad(lambda q: jnp.sum(
        JG.knn_points(q, jnp.asarray(p), 1).dists))(jnp.asarray(q))
    qt = _t(q, grad=True)
    pt = _t(p)
    from hitadv_torch.ops import kernels as K

    calls = []
    real = K.scatter_add_rows
    K.scatter_add_rows = lambda *a: calls.append(a) or real(*a)
    try:
        G.knn_points(qt, pt, 1).dists.sum().backward()
    finally:
        K.scatter_add_rows = real
    assert pt.grad is None
    # the gather's scatter-add is not needed either: only the query share
    assert calls == []
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_query_ball_point_matches_xla():
    """Against the reference's XLA path (matmul distances, sort and
    fill): at this seed no point lies within rounding of the rim, so the
    indices agree; short balls (padded) and empty ones (N - 1) included."""
    xyz = _cloud(18, 2, 300)
    new_xyz = xyz[:, :64].copy()
    new_xyz[:, -2:] += 20.0
    want = np.asarray(JG.query_ball_point(0.4, 16, jnp.asarray(xyz),
                                          jnp.asarray(new_xyz)))
    got = G.query_ball_point(0.4, 16, _t(xyz, grad=True), _t(new_xyz))
    assert got.dtype == torch.int32 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, -2:] == 299).all()
    assert (want[:, :, -1] == want[:, :, 0]).any()


def test_gather_group_nm_value_and_grad():
    x = _cloud(19, 2, 100, 6)
    idx = np.random.RandomState(20).randint(0, 100, (2, 30, 7)).astype(
        np.int32)
    wgt = np.random.RandomState(21).randn(2, 7, 30, 6).astype(np.float32)
    want, vjp = jax.vjp(lambda p: JG.gather_group_nm(p, jnp.asarray(idx)),
                        jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(wgt))
    xt = _t(x, grad=True)
    got = G.gather_group_nm(xt, _t(idx))
    assert got.shape == (2, 7, 30, 6)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got * _t(wgt)).sum().backward()
    # XLA's scatter-add and the port's ascending f32 sum: rounding apart
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-6)


def test_max_axis_splits_ties_like_the_jax_vjp():
    """Short balls repeat their first index, so the neighbour max meets
    exact ties; the gradient splits among them as the JAX custom VJP's
    ``mask * (g / count)`` does, and not as torch.max's single slot."""
    from hitadv_tpu.nn import functional as jnnF
    from hitadv_torch.nn import functional as F

    x = _cloud(22, 2, 40, 5)
    centres = x[:, :12, :3].copy()
    idx = np.asarray(JG.query_ball_point(0.8, 8, jnp.asarray(x[..., :3]),
                                         jnp.asarray(centres)))
    assert (idx[..., -1] == idx[..., 0]).any()     # padded: duplicates
    wgt = np.random.RandomState(23).randn(2, 12, 5).astype(np.float32)

    def jloss(p):
        return jnp.sum(jnnF.max_axis(JG.gather_group_nm(
            p, jnp.asarray(idx)), 1) * wgt)
    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = _t(x, grad=True)
    got = F.max_axis(G.gather_group_nm(xt, _t(idx)), 1)
    (got * _t(wgt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=1e-6,
                               atol=1e-6)
    # each duplicate holds an equal share: the split is visible per slot
    grouped = _t(x, grad=True)
    h = G.gather_group_nm(grouped, _t(idx))
    h.retain_grad()
    (F.max_axis(h, 1) * _t(wgt)).sum().backward()
    slot_g = h.grad.numpy()                          # [B, ns, S, C]
    b, s = np.argwhere(idx[..., -1] == idx[..., 0])[0]
    np.testing.assert_array_equal(slot_g[b, 0, s], slot_g[b, -1, s])
    assert np.abs(slot_g[b, 0, s]).sum() > 0


def test_set_abstraction_front_ends_match():
    """`sample_and_group` (ball query), `sample_and_group_all`,
    `knn_point` and `sample_and_group_knn` against the reference's,
    FPS from index 0."""
    xyz, pts = _cloud(24, 2, 200), _cloud(25, 2, 200, 8)
    jx, jp = jnp.asarray(xyz), jnp.asarray(pts)
    for concat in (True, False):
        want = JG.sample_and_group(64, 0.6, 16, jx, jp, concat=concat)
        got = G.sample_and_group(64, 0.6, 16, _t(xyz), _t(pts),
                                 concat=concat)
        for w, g in zip(jax.tree_util.tree_leaves(want),
                        [got[0], *(got[1] if not concat else (got[1],))]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = JG.sample_and_group_all(jx, jp)
    got = G.sample_and_group_all(_t(xyz), _t(pts))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        G.knn_point(8, _t(xyz), _t(xyz[:, :50])).numpy(),
        np.asarray(JG.knn_point(8, jx, jnp.asarray(xyz[:, :50]))))
    for concat in (True, False):
        want = JG.sample_and_group_knn(50, 8, jx, jp, concat=concat)
        got = G.sample_and_group_knn(50, 8, _t(xyz), _t(pts), concat=concat)
        for w, g in zip(jax.tree_util.tree_leaves(want),
                        [got[0], *(got[1] if not concat else (got[1],))]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _pallas_grad(fn, args, argnums):
    """``jax.grad`` of ``fn`` with the JAX geometry on its Pallas path
    (interpret mode on the CPU); the knob goes back to XLA after."""
    JG.set_backend("pallas")
    try:
        return jax.value_and_grad(fn, argnums=argnums)(*args)
    finally:
        JG.set_backend("xla")


@pytest.mark.parametrize("N,bw", [(130, 0.15), (200, 0.1)])
def test_kde_density_value_and_grad(N, bw):
    """`geometry.kde_density` (an autograd Function over the KDE pair)
    against the JAX custom VJP on its Pallas path, and the value against
    the XLA path."""
    x = _cloud(30, 2, N) * 0.5
    w = np.random.RandomState(31).randn(2, N).astype(np.float32)
    jv, jg = _pallas_grad(lambda v: jnp.sum(JG.kde_density(v, bw) * w),
                          (jnp.asarray(x),), 0)
    xt = _t(x, grad=True)
    dens = G.kde_density(xt, bw)
    v = (dens * _t(w)).sum()
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-5)
    # the Pallas backward's expanded form cancels at the ~1e-5 level; the
    # port sums the product form in f64
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jg)).max())
    # the XLA path's matmul-form distances cancel near d = 0 (the JAX
    # package's own tolerance for it)
    np.testing.assert_allclose(
        dens.detach().numpy(), np.asarray(JG.kde_density(jnp.asarray(x), bw)),
        rtol=2e-4, atol=1e-5)


def test_gaussian_blend_negdt_grads_all_args():
    """`geometry.gaussian_blend_negdt` against the JAX custom VJP on its
    Pallas path: values, and the cotangents of the field (plain PyTorch),
    the widths and the translations (the backward kernel's plain
    version), at `tests/test_pallas_kernels.py`'s shape."""
    from test_torch_kernels import _blend_inputs

    rng = np.random.RandomState(32)
    negdt, delta, pert = _blend_inputs(rng, 2, 12, 130)
    w_num = rng.randn(2, 130, 3).astype(np.float32)
    w_deno = rng.randn(2, 130).astype(np.float32)

    def loss(nt, d, p):
        num, deno = JG.gaussian_blend_negdt(nt, d, p)
        return jnp.sum(num * w_num) + jnp.sum(deno * w_deno)

    jv, jgrads = _pallas_grad(loss, [jnp.asarray(a) for a in
                                     (negdt, delta, pert)], (0, 1, 2))
    ts = [_t(a, grad=True) for a in (negdt, delta, pert)]
    num, deno = G.gaussian_blend_negdt(*ts)
    v = (num * _t(w_num)).sum() + (deno * _t(w_deno)).sum()
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-5)
    for t, want, name in zip(ts, jgrads, ("negdt", "delta", "pert")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # the blend from the untransposed field (plain exp + einsum) gives
    # the same values
    field_num, field_deno = G._blend_from_negd(
        _t(negdt).transpose(1, 2), _t(delta), _t(pert))
    np.testing.assert_allclose(num.detach().numpy(), field_num.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(deno.detach().numpy(), field_deno.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,Cn,N", [(2, 12, 130), (1, 192, 300)])
def test_gaussian_blend_fused_values_and_all_four_grads(B, Cn, N):
    """`geometry.gaussian_blend_fused` (an autograd Function over the fused
    pair) against ``jax.vjp`` of the JAX package's `gaussian_blend_fused`
    (its XLA program on the CPU): values and the cotangents of the
    centres, the cloud, the widths and the translations. Centres are cloud
    points (the d = 0 corner, where both keep the product form)."""
    rng = np.random.RandomState(33)
    ori = rng.randn(B, N, 3).astype(np.float32)
    sel = rng.randint(0, N, size=(B, Cn))
    central = np.stack([ori[b, sel[b]] for b in range(B)])
    delta = (0.1 + rng.rand(B, Cn) * 1.1).astype(np.float32)
    pert = (rng.randn(B, Cn, 3) * 0.1).astype(np.float32)
    g_num = rng.randn(B, N, 3).astype(np.float32)
    g_deno = rng.randn(B, N).astype(np.float32)
    args = (central, ori, delta, pert)
    (jnum, jdeno), vjp = jax.vjp(JG.gaussian_blend_fused,
                                 *[jnp.asarray(a) for a in args])
    jgrads = vjp((jnp.asarray(g_num), jnp.asarray(g_deno)))
    ts = [_t(a, grad=True) for a in args]
    num, deno = G.gaussian_blend_fused(*ts)
    grads = torch.autograd.grad((num, deno), ts, (_t(g_num), _t(g_deno)))
    # the XLA program sums f32 products in f32 (HIGHEST einsum, autodiff
    # through sqrt and exp), the port exact f64 products in f64
    np.testing.assert_allclose(num.detach().numpy(), np.asarray(jnum),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(deno.detach().numpy(), np.asarray(jdeno),
                               rtol=1e-5, atol=1e-6)
    for got, want, name in zip(grads, jgrads,
                               ("central", "ori", "delta", "pert")):
        want = np.asarray(want)
        assert got.shape == want.shape, name
        assert np.linalg.norm(got.numpy() - want) <= 1e-5 * np.linalg.norm(
            want), name
    # only the inputs that need a gradient get one
    leaves = [_t(a, grad=(i == 3)) for i, a in enumerate(args)]
    num, deno = G.gaussian_blend_fused(*leaves)
    (num.sum() + deno.sum()).backward()
    assert leaves[3].grad is not None and leaves[0].grad is None


def _unknown_known(seed, B=2, N=100, M=30):
    """Dense and sparse clouds apart from each other: no point of one is a
    point of the other, so no 3-NN distance is 0."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, N, 3).astype(np.float32),
            rng.randn(B, M, 3).astype(np.float32))


def test_three_nn_and_interpolate_weights():
    """`three_nn`: the three nearest known points, Euclidean distances,
    indices equal to JAX's first; `interpolate_weights` on the same
    distances."""
    unknown, known = _unknown_known(40)
    jd, jidx = JG.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    d, idx = G.three_nn(_t(unknown), _t(known))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.dtype == torch.int32 and d.shape == (2, 100, 3)
    # the JAX XLA path takes the matmul distance form, the port the
    # elementwise one: f32 rounding apart
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-5)
    sq = np.asarray(jd) ** 2
    np.testing.assert_allclose(
        G.interpolate_weights(_t(sq)).numpy(),
        np.asarray(JG.interpolate_weights(jnp.asarray(sq))), rtol=1e-6,
        atol=1e-7)


def test_three_interpolate_value_and_grads():
    """`three_interpolate` against JAX on the same indices and weights:
    the value, and the gradients to the known features (the row scatter)
    and to the weights."""
    unknown, known = _unknown_known(41)
    rng = np.random.RandomState(42)
    feats = rng.randn(2, 30, 7).astype(np.float32)
    g = rng.randn(2, 100, 7).astype(np.float32)
    _, jidx = JG.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    _, idx = G.three_nn(_t(unknown), _t(known))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    weight = rng.rand(2, 100, 3).astype(np.float32)

    def jloss(p, w):
        out = JG.three_interpolate(p, jidx, w)
        return jnp.sum(out * g), out

    (_, jout), (jgp, jgw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(feats),
                                              jnp.asarray(weight))
    pt, wt = _t(feats, grad=True), _t(weight, grad=True)
    out = G.three_interpolate(pt, idx, wt)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jgp), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["group_points", "knn_gather"])
def test_group_points_and_knn_gather(name):
    """pointnet2_ops' `group_points` and pytorch3d's `knn_gather`: the
    value and the gradient to the points against JAX's."""
    x = _cloud(43, 2, 90, 5)
    idx = np.random.RandomState(44).randint(0, 90, (2, 20, 6)).astype(
        np.int32)
    wgt = np.random.RandomState(45).randn(2, 20, 6, 5).astype(np.float32)
    jfn, fn = getattr(JG, name), getattr(G, name)
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(idx)))
    want_g = np.asarray(jax.grad(lambda p: jnp.sum(
        jfn(p, jnp.asarray(idx)) * wgt))(jnp.asarray(x)))
    xt = _t(x, grad=True)
    got = fn(xt, _t(idx))
    assert got.shape == (2, 20, 6, 5)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (got * _t(wgt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=1e-6,
                               atol=1e-6)


def test_ops_package_reexports_the_geometry_api():
    """`hitadv_torch.ops` exports the JAX package's geometry names but for
    its Pallas backend switch and its validation switch, each the port's
    function."""
    import hitadv_tpu.ops as JO
    import hitadv_torch.ops as O

    want = {n for n in dir(JO) if not n.startswith("_")} - {
        "set_backend", "get_backend", "set_validation", "geometry",
        "pallas_kernels"}
    got = {n for n in dir(O) if not n.startswith("_")}
    assert want <= got
    for n in want:
        assert getattr(O, n) is getattr(G, n)


def _bad_inputs():
    """(geometry function name, arguments as numpy arrays) that break the
    contract checks, one per check of each function."""
    f32 = np.zeros((2, 8, 3), np.float32)
    i32 = np.zeros((2, 8, 3), np.int32)
    idx = np.zeros((2, 4), np.int32)
    return [
        ("square_distance", (f32[0], f32)),
        ("square_distance", (f32, i32)),
        ("index_points", (f32[0], idx)),
        ("index_points", (i32, idx)),
        ("index_points", (f32, idx.astype(np.float32))),
        ("gather_group_nm", (i32, idx[..., None])),
        ("gather_group_nm", (f32, idx[..., None].astype(np.float32))),
        ("farthest_point_sample", (f32[0], 4)),
        ("farthest_point_sample", (i32, 4)),
        ("query_ball_point", (0.2, 4, f32[0], f32)),
        ("query_ball_point", (0.2, 4, f32, i32)),
    ]


@pytest.mark.parametrize("case", range(len(_bad_inputs())))
def test_contract_checks_raise_as_jax(case):
    """A cloud of the wrong rank raises `ValueError`, a cloud of an int
    dtype or float indices `TypeError`, with JAX's message."""
    name, args = _bad_inputs()[case]

    def call(mod, conv):
        with pytest.raises((ValueError, TypeError)) as err:
            getattr(mod, name)(*[conv(a) if isinstance(a, np.ndarray) else a
                                 for a in args])
        return err

    want = call(JG, jnp.asarray)
    got = call(G, torch.from_numpy)
    assert got.type is want.type
    assert str(got.value) == str(want.value)
