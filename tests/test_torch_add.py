"""The port's Add attacks, their seeding and their distances against
`hitadv_tpu`.

Both packages get the same numpy inputs, the same parameter tree and the
same pinned draws; the port runs on the CPU in f32. The trajectory tests
put the JAX side on its Pallas path (interpret mode), as the CW ones do:
there the max-pool's gradient goes to the first argmax row and the
Chamfer's is ``2 g (q - p)``, as in the port. Their pinned start noise is
1e-2, not the attacks' 1e-7: an added point 1e-7 from the original point
it copies ties with it in the max-pools within f32 rounding, so which of
the two takes a channel's gradient, and the first step, would be
rounding's choice, differently in each package.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu import losses as JL
from hitadv_tpu.attacks import add as JA
from hitadv_tpu.attacks import base as JB
from hitadv_tpu.data import synthetic_clouds
from hitadv_tpu.models import pointnet as JP
from hitadv_tpu.ops import geometry as JG
from hitadv_torch import losses as L
from hitadv_torch.attacks import add as A
from hitadv_torch.attacks import make_adv_fn
from hitadv_torch.convert import params_from_numpy
from hitadv_torch.models import PointNet
from test_torch_kernels import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def xla_backend():
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


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


# ---------------------------------------------------------------------------
# Host-side seeding
# ---------------------------------------------------------------------------

def _critical_like(seed, B=3, n=48):
    """Critical-point-like clouds: two tight blobs (clusters for DBSCAN)
    and scattered points (noise), and in the last cloud no blob at all,
    so that the fallback draws."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    pts[0, :10] = 0.3 + 0.02 * rng.randn(10, 3)
    pts[0, 10:16] = -0.5 + 0.02 * rng.randn(6, 3)
    pts[1, :12] = 0.1 * rng.randn(12, 3)
    return pts


def test_dbscan_np_matches_jax():
    pts = _critical_like(0)
    for cloud in pts:
        got = A.dbscan_np(cloud, 0.2, 3)
        np.testing.assert_array_equal(got, JA.dbscan_np(cloud, 0.2, 3))
    labels = A.dbscan_np(pts[0], 0.2, 3)
    assert labels.max() >= 1 and (labels == -1).any()


@pytest.mark.parametrize("as_centers", [False, True])
def test_cluster_seeds_match_jax_with_fallback(as_centers):
    """The same seeds from the same RandomState, the fallback included
    (three clusters asked of clouds with two, one and none), and a second
    call on each package's shared RandomState (the object attack draws
    from one across batches) equal again."""
    pts = _critical_like(1)
    mine, theirs = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(2):
        got = A._cluster_seeds(pts, 3, 4, mine, as_centers=as_centers)
        want = JA._cluster_seeds(pts, 3, 4, theirs, as_centers=as_centers)
        np.testing.assert_array_equal(got, want)
    assert got.shape == ((3, 3, 3) if as_centers else (3, 3, 4, 3))
    # the two packages' states stayed in step
    assert mine.randint(1 << 30) == theirs.randint(1 << 30)
    # and the fallback ran: some cloud has fewer than three clusters
    assert min(A.dbscan_np(c, 0.2, 3).max() + 1 for c in pts) < 3


def test_default_object_pc_matches_jax():
    np.testing.assert_array_equal(A.default_object_pc(100, seed=3),
                                  JA.default_object_pc(100, seed=3))


# ---------------------------------------------------------------------------
# Critical points
# ---------------------------------------------------------------------------

def test_get_critical_points_takes_tied_zeros_in_index_order(victims):
    """The later copy of a duplicated point is no max-pool's argmax (the
    first row wins, on the JAX package's Pallas path as in the port; its
    XLA path splits the cotangent among ties), so its CE gradient is
    exactly zero: 40 of the 104 points tie at 0, and the cut of 80 falls
    inside that block. Both packages must take the tied points in index
    order, as `lax.top_k` does."""
    JG.set_backend("pallas")
    jfn, model = victims
    pts, labels = synthetic_clouds(2, 64, seed=4)
    xyz = pts[..., :3]
    cloud = np.concatenate([xyz, xyz[:, :40]], axis=1)       # [2, 104, 3]
    jgrad = np.asarray(jax.grad(lambda x: jnp.mean(JL.cross_entropy_loss(
        jfn(x), jnp.asarray(labels))))(jnp.asarray(cloud)))
    score = (jgrad ** 2).sum(-1)
    assert (score[:, 64:] == 0).all()
    order = np.argsort(-score, axis=1, kind="stable")
    nonzero = (score > 0).sum(1)
    assert (nonzero < 80).all() and ((score == 0).sum(1) > 80 - nonzero).all()
    # no near-tie among the nonzero scores that the two packages' rounding
    # could swap: each gap between neighbours in the order wider than
    # the two scores' differences between the packages together
    x = _t(cloud, True)
    torch.mean(L.cross_entropy_loss(model(x), _t(labels).long())).backward()
    tscore = (x.grad.numpy() ** 2).sum(-1)
    np.testing.assert_array_equal(tscore == 0, score == 0)
    for b in range(2):
        nz = order[b][:nonzero[b]]
        err = np.abs(tscore[b] - score[b])[nz]
        assert (-np.diff(score[b][nz]) > err[1:] + err[:-1]).all()
    want = np.asarray(JA.get_critical_points(jfn, jnp.asarray(cloud),
                                             jnp.asarray(labels), 80))
    got = A.get_critical_points(model, _t(cloud), _t(labels).long(),
                                80).numpy()
    np.testing.assert_array_equal(want, np.take_along_axis(
        cloud, order[:, :80, None], axis=1))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Distances
# ---------------------------------------------------------------------------

def _value_and_grads(jf, tf, args):
    """Values and the gradients of ``sum(f(*args) * w)`` as (port, JAX)
    pairs, w a fixed weight per example."""
    w = np.random.RandomState(9).randn(args[0].shape[0]).astype(np.float32)
    n = len(args)
    want_v = np.asarray(jf(*map(jnp.asarray, args)))
    want_g = jax.grad(lambda *a: jnp.sum(jf(*a) * w), argnums=tuple(
        range(n)))(*map(jnp.asarray, args))
    ts = [_t(a, True) for a in args]
    got = tf(*ts)
    (got * _t(w)).sum().backward()
    pairs = [(got.detach().numpy(), want_v)]
    for t, g in zip(ts, want_g):
        pairs.append((np.zeros_like(np.asarray(g)) if t.grad is None
                      else t.grad.numpy(), np.asarray(g)))
    return pairs


def _clusters(seed, B=2, na=3, npts=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, na, 1, 3) * 0.5
            + 0.1 * rng.randn(B, na, npts, 3)).astype(np.float32)


def test_farthest_dist():
    c = _clusters(0)
    # the norm of a difference and the max: f32 rounding only
    for got, want in _value_and_grads(JL.farthest_dist, L.farthest_dist,
                                      (c,)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_far_chamfer_dist():
    adv = _clusters(1).reshape(2, 24, 3)
    ori = np.random.RandomState(2).randn(2, 64, 3).astype(np.float32) * 0.5
    # the Chamfer term's matmul (JAX XLA) and elementwise (port) distance
    # forms round O(1) squared distances apart
    for got, want in _value_and_grads(
            lambda a, o: JL.far_chamfer_dist(a, o, 3),
            lambda a, o: L.far_chamfer_dist(a, o, 3), (adv, ori)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_l2_chamfer_dist():
    rng = np.random.RandomState(3)
    objs = rng.randn(2, 3, 8, 3).astype(np.float32) * 0.3
    clean = objs + 0.05 * rng.randn(*objs.shape).astype(np.float32)
    adv = objs.reshape(2, 24, 3) + 0.2
    ori = rng.randn(2, 64, 3).astype(np.float32) * 0.5
    # as `test_far_chamfer_dist`
    for got, want in _value_and_grads(JL.l2_chamfer_dist, L.l2_chamfer_dist,
                                      (adv, ori, objs, clean)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Trajectories under pinned draws
# ---------------------------------------------------------------------------

def _targets(jfn, xyz):
    """The clean prediction for the first half of the batch (those succeed
    at once) and the runner-up class for the rest."""
    logits = np.asarray(jfn(jnp.asarray(xyz)))
    order = np.argsort(-logits, axis=1)
    half = xyz.shape[0] // 2
    return np.concatenate([order[:half, 0], order[half:, 1]]).astype(
        np.int32)


ADV_J = JB.make_adv_fn("logits", 0.0, targeted=True)


def _compare(got, want, n, atol):
    np.testing.assert_array_equal(got.adv_points.numpy()[:, :n],
                                  np.asarray(want.adv_points)[:, :n])
    np.testing.assert_allclose(got.adv_points.numpy(),
                               np.asarray(want.adv_points), atol=atol)
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))


def test_pinned_noise_cw_add_trajectory(victims):
    JG.set_backend("pallas")
    jfn, model = victims
    pts, _ = synthetic_clouds(4, 64, seed=3)
    labels = _targets(jfn, pts[..., :3])
    noise = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                       (2, 4, 24, 3)) * 1e-2)
    kw = dict(binary_step=2, num_iter=5, num_add=24)
    want = JA.make_cw_add(jfn, ADV_J, cfg=JA.AddConfig(**kw),
                          init_overrides={"noise": noise})(
        jnp.asarray(pts[..., :3]), jnp.asarray(labels),
        jax.random.PRNGKey(0))
    got = A.make_cw_add(model, make_adv_fn("logits", 0.0, targeted=True),
                        cfg=A.AddConfig(**kw),
                        init_overrides={"noise": noise}, device="cpu")(
        pts, labels)
    # f32 in other op orders; Adam's normalised steps of 1e-2 keep a
    # rounding difference near its size: a thousandth of one step
    _compare(got, want, 64, 1e-5)
    assert got.success.any() and not got.success.all()


def test_pinned_noise_cw_add_clusters_trajectory(victims):
    """The DBSCAN seeds from both packages' critical points (the fresh
    RandomState(seed) of each call), the pinned noise, 2 x 5."""
    JG.set_backend("pallas")
    jfn, model = victims
    pts, _ = synthetic_clouds(4, 64, seed=5)
    labels = _targets(jfn, pts[..., :3])
    noise = np.array(jax.random.normal(jax.random.PRNGKey(2),
                                       (2, 4, 16, 3)) * 1e-2)
    kw = dict(binary_step=2, num_iter=5, num_add=2, cl_num_p=8, num_cri=24)
    want = JA.make_cw_add_clusters(jfn, ADV_J, cfg=JA.AddClusterConfig(**kw),
                                   seed=3, init_overrides={"noise": noise})(
        jnp.asarray(pts), jnp.asarray(labels), jax.random.PRNGKey(0))
    attack = A.make_cw_add_clusters(
        model, make_adv_fn("logits", 0.0, targeted=True),
        cfg=A.AddClusterConfig(**kw), seed=3,
        init_overrides={"noise": noise}, device="cpu")
    got = attack(pts, labels)
    # as the CW-Add trajectory
    _compare(got, want, 64, 1e-5)
    # a fresh RandomState each call: a second call repeats the first
    again = attack(pts, labels)
    assert torch.equal(again.adv_points, got.adv_points)


def test_pinned_draws_cw_add_objects_trajectory(victims):
    """Pinned noise and angles; the objects' subsets and the DBSCAN
    centres from each package's own RandomState(seed), 2 x 5; then a
    second batch on the same attack, whose fallback keeps drawing from
    that state."""
    JG.set_backend("pallas")
    jfn, model = victims
    pts, _ = synthetic_clouds(4, 64, seed=7)
    labels = _targets(jfn, pts[..., :3])
    kw = dict(binary_step=2, num_iter=5, num_add=2, obj_num_p=8, num_cri=24)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    over = {"noise_obj": np.array(jax.random.normal(keys[0],
                                                    (2, 4, 2, 8, 3)) * 1e-2),
            "noise_shift": np.array(jax.random.normal(keys[1],
                                                      (2, 4, 2, 3)) * 1e-2),
            "angles": np.array(jax.random.uniform(keys[2], (2, 4, 2, 3))
                               * np.pi)}
    jatk = JA.make_cw_add_objects(jfn, ADV_J, cfg=JA.AddObjectConfig(**kw),
                                  seed=4, init_overrides=over)
    tatk = A.make_cw_add_objects(
        model, make_adv_fn("logits", 0.0, targeted=True),
        cfg=A.AddObjectConfig(**kw), seed=4, init_overrides=over,
        device="cpu")
    for p, lab in ((pts, labels), (pts[::-1].copy(), labels[::-1].copy())):
        want = jatk(jnp.asarray(p), jnp.asarray(lab), jax.random.PRNGKey(0))
        got = tatk(p, lab)
        # as the CW-Add trajectory; the rotation's 3-term sums in other
        # orders too
        _compare(got, want, 64, 1e-5)
    angles_wrapped = np.asarray(want.adv_points)
    assert np.isfinite(angles_wrapped).all()


def test_add_attacks_need_a_generator_unless_pinned(victims):
    _, model = victims
    pts, labels = synthetic_clouds(2, 64, seed=8)
    adv = make_adv_fn("logits", 0.0, targeted=True)
    attacks = [
        A.make_cw_add(model, adv, cfg=A.AddConfig(binary_step=1, num_iter=2,
                                                  num_add=8), device="cpu"),
        A.make_cw_add_clusters(model, adv, cfg=A.AddClusterConfig(
            binary_step=1, num_iter=2, num_add=2, cl_num_p=4, num_cri=16),
            device="cpu"),
        A.make_cw_add_objects(model, adv, cfg=A.AddObjectConfig(
            binary_step=1, num_iter=2, num_add=2, obj_num_p=4, num_cri=16),
            device="cpu")]
    for attack, n_add in zip(attacks, (8, 8, 8)):
        with pytest.raises(ValueError, match="Generator"):
            attack(pts, labels)
        a = attack(pts, labels, torch.Generator().manual_seed(2))
        assert a.adv_points.shape == (2, 64 + n_add, 3)
        assert torch.equal(a.adv_points[:, :64],
                           torch.from_numpy(pts[..., :3]))
    with pytest.raises(ValueError, match="lacks"):
        A.make_cw_add_objects(model, adv, init_overrides={"angles": 0},
                              device="cpu")
