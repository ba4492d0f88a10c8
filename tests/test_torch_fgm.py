"""The port's FGM family (`hitadv_torch.attacks.fgm`) against
`hitadv_tpu.attacks.fgm` on the CPU.

Both packages get the same PointNet parameter tree, the same clouds and
the same random starts (the JAX draws, pinned in the port through
``init_overrides``); every maker runs over at most 5 iterations.

A sign step turns the f32 rounding noise of a gradient component near 0
into a full move of two steps, after which the trajectories part. So the
sign-based makers (FGSM, IFGSM, PGD, MIFGSM, FGSM-RS) are replayed step
by step: the test records the iterates the port's victim is called on,
computes JAX's gradient at each (JAX's `_grad_and_pred`; for MIFGSM
JAX's momentum from those gradients) and JAX's step rule from it, and
holds the port's next iterate to it on every component whose sign is
decided: exactly 0 (a point no max-pool channel takes, 0 in both
packages) or above ``MARGIN`` of the cloud's largest, where the two
packages' gradients differ by under a tenth of that. The rest (a few
percent of the components) may take either sign: the port's coordinate
must be one of the three moves (-1, 0, +1 step, then the clips), and
their share is bounded. The final prediction is JAX's at the port's
final cloud. The L2-normalised makers (FGM-L2, IFGM-L2) move
continuously and are held to the JAX makers' output directly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu.attacks import base as JB
from hitadv_tpu.attacks import fgm as JF
from hitadv_tpu.data import synthetic_clouds
from hitadv_tpu.models import pointnet as JP
from hitadv_tpu.ops import geometry as JG
from hitadv_torch.attacks import fgm as F
from hitadv_torch.attacks import make_adv_fn
from hitadv_torch.convert import params_from_numpy
from hitadv_torch.models import PointNet
from test_torch_kernels import one_torch_thread  # noqa: F401

# a decided sign: |g| above this share of the cloud's largest |g|; the
# two packages' f32 gradients of this victim differ by at most 8.4e-7 of
# it (the clean clouds of six seeds measured), and their exact zeros
# coincide
MARGIN = 1e-5
# the adversarial clouds of equal signs: coordinates of |x| <= 1 after a
# few exactly representable steps, f32 rounding of the L2 ones
ATOL = 1e-6
SEED = 9
CFG = F.FGMConfig(budget=0.1, num_iter=5)
JCFG = JF.FGMConfig(budget=0.1, num_iter=5)


@pytest.fixture(autouse=True)
def xla_backend():
    prev = JG.get_backend()
    JG.set_backend("xla")
    try:
        yield
    finally:
        JG.set_backend(prev)


@pytest.fixture(scope="module")
def setup():
    """(JAX logits fn, the port's recording victim, its record, clouds,
    labels, JAX's jitted gradient of the batch-mean CE)."""
    tree = jax.tree_util.tree_map(np.asarray, JP.init(jax.random.PRNGKey(42)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jfn = jax.jit(lambda x: JP.apply(params, x))
    model = PointNet(params=params_from_numpy(tree, "cpu"), device="cpu")
    seen = []

    def recording(x):
        seen.append(x.detach().clone())
        return model(x)

    pts, labels = synthetic_clouds(2, 128, seed=SEED)
    ce = JB.make_adv_fn("cross_entropy")
    jgrad = jax.jit(lambda p, lab: JF._grad_and_pred(jfn, ce, p, lab)[0])
    return jfn, recording, seen, pts[..., :3].copy(), labels, jgrad


def _draws(name, key, shape):
    """The JAX maker's random starts, as the port's ``init_overrides``."""
    if name in ("ifgsm", "ifgm_l2", "mifgsm"):
        return {"noise": np.array(jax.random.normal(key, shape) * 1e-7)}
    if name == "pgd":
        k1, k2 = jax.random.split(key)
        return {"start": np.array(jax.random.uniform(
                    k1, shape, minval=-JCFG.budget, maxval=JCFG.budget)),
                "noise": np.array(jax.random.normal(k2, shape) * 1e-7)}
    if name == "fgsm_rs":
        return {"start": np.array(jax.random.uniform(
            key, shape, minval=-JCFG.budget, maxval=JCFG.budget))}
    return None


def _assert_decided(v, what):
    """Every component of ``v`` [B, N, 3] is 0 or above MARGIN of its
    cloud's largest."""
    v = np.abs(np.asarray(v)).reshape(v.shape[0], -1)
    top = v.max(axis=1, keepdims=True)
    small = (v > 0) & (v <= MARGIN * top)
    assert top.min() > 0 and not small.any(), (
        f"{what}: {int(small.sum())} gradient components within the "
        "rounding margin; pick clouds without them")


def _replay(name, xs, final, pts, labels, jfn, jgrad):
    """Hold each port step ``xs[t] -> xs[t + 1]`` (``final`` last) to
    JAX's rule on the decided components; return the undecided share."""
    clip = JF._clip_fn(JCFG)
    one_step = name in ("fgsm", "fgsm_rs")
    step = JCFG.budget if one_step else JCFG.step
    pc0 = jnp.asarray(xs[0])
    around = {"fgsm": lambda p: p,
              "fgsm_rs": lambda p: clip(p, jnp.asarray(pts))}.get(
                  name, lambda p: clip(p, pc0))
    m, undecided = 0.0, 0
    for x, nxt in zip(xs, xs[1:] + [final]):
        g = np.asarray(jgrad(jnp.asarray(x), jnp.asarray(labels)))
        if name == "mifgsm":
            m = CFG.mu * m + g / (np.abs(g).sum(axis=(1, 2))[:, None, None]
                                  + 1e-9)
            g = m / (np.sqrt((m ** 2).sum(axis=(1, 2)))[:, None, None]
                     + 1e-9)

        def move(sign):
            return np.asarray(jnp.clip(around(jnp.asarray(x) + step * sign),
                                       -1.0, 1.0))

        top = np.abs(g).reshape(len(g), -1).max(axis=1)[:, None, None]
        decided = (g == 0) | (np.abs(g) > MARGIN * top)
        np.testing.assert_allclose(nxt[decided],
                                   move(jnp.sign(jnp.asarray(g)))[decided],
                                   atol=ATOL)
        legal = np.zeros(x.shape, bool)
        for s in (-1.0, 0.0, 1.0):
            legal |= np.abs(nxt - move(s)) <= ATOL
        assert legal.all()
        undecided += int((~decided).sum())
    want = np.asarray(jnp.argmax(jfn(jnp.asarray(final)), -1))
    return undecided / (len(xs) * final.size), want


@pytest.mark.parametrize("name", ["fgsm", "fgm_l2", "ifgsm", "ifgm_l2",
                                  "pgd", "mifgsm", "fgsm_rs"])
def test_trajectory_matches_jax(setup, name):
    jfn, recording, seen, pts, labels, jgrad = setup
    key = jax.random.PRNGKey(3)
    maker = f"make_{name}"
    kw = {} if name in ("fgsm", "fgm_l2") else dict(
        init_overrides=_draws(name, key, pts.shape))
    seen.clear()
    got = getattr(F, maker)(recording, make_adv_fn("cross_entropy"), CFG,
                            device="cpu", **kw)(pts, labels)
    xs = [x.numpy() for x in seen[:-1]]      # the last call predicts
    assert len(xs) == (1 if name in ("fgsm", "fgm_l2", "fgsm_rs")
                       else CFG.num_iter)
    adv = got.adv_points.numpy()
    if name in ("fgm_l2", "ifgm_l2"):
        want = getattr(JF, maker)(jfn, JB.make_adv_fn("cross_entropy"),
                                  JCFG)(jnp.asarray(pts), jnp.asarray(labels),
                                        key)
        np.testing.assert_allclose(adv, np.asarray(want.adv_points),
                                   atol=ATOL)
        pred = np.asarray(want.pred)
    else:
        share, pred = _replay(name, xs, adv, pts, labels, jfn, jgrad)
        assert share <= 0.05, share
    np.testing.assert_array_equal(got.pred.numpy(), pred)
    np.testing.assert_array_equal(got.success.numpy(), pred != labels)
    assert np.abs(adv).max() <= 1.0
    assert np.abs(adv - pts).max() > 1e-3            # it moved


def test_budgets_and_clips(setup):
    """The L-inf ball around the jittered start (PGD, the reference's
    quirk), the clean cloud (FGSM-RS) or the 1e-7 start (IFGSM, here
    zero), and [-1, 1]."""
    _, recording, _, pts, labels, _ = setup
    ce = make_adv_fn("cross_entropy")
    rng = np.random.RandomState(0)
    start = rng.uniform(-0.1, 0.1, pts.shape).astype(np.float32)
    noise = np.zeros_like(pts)
    pgd = F.make_pgd(recording, ce, CFG, device="cpu", init_overrides=dict(
        start=start, noise=noise))(pts, labels).adv_points.numpy()
    assert np.abs(pgd - (pts + start)).max() <= 0.1 + 1e-6
    assert np.abs(pgd - pts).max() > 0.1 + 1e-3      # past the clean ball
    rs = F.make_fgsm_rs(recording, ce, CFG, device="cpu", init_overrides=dict(
        start=start))(pts, labels).adv_points.numpy()
    assert np.abs(rs - pts).max() <= 0.1 + 1e-6
    # three steps of 2 * 0.05 / 3 reach past the ball, which holds them
    ifgsm = F.make_ifgsm(recording, ce, F.FGMConfig(budget=0.05, num_iter=3),
                         device="cpu", init_overrides=dict(noise=noise))(
        pts, labels).adv_points.numpy()
    np.testing.assert_allclose(np.abs(ifgsm - pts).max(), 0.05, atol=1e-6)
    for adv in (pgd, rs, ifgsm):
        assert np.abs(adv).max() <= 1.0


def test_draws_need_a_generator_unless_pinned(setup):
    _, recording, _, pts, labels, _ = setup
    ce = make_adv_fn("cross_entropy")
    cfg = F.FGMConfig(budget=0.1, num_iter=2)
    for maker in (F.make_ifgsm, F.make_pgd, F.make_mifgsm, F.make_fgsm_rs,
                  F.make_ifgm_l2):
        attack = maker(recording, ce, cfg, device="cpu")
        with pytest.raises(ValueError, match="Generator"):
            attack(pts, labels)
        a = attack(pts, labels, torch.Generator().manual_seed(4))
        b = attack(pts, labels, torch.Generator().manual_seed(4))
        assert torch.equal(a.adv_points, b.adv_points)
    with pytest.raises(ValueError, match="lacks"):
        F.make_pgd(recording, ce, cfg, device="cpu",
                   init_overrides={"noise": np.zeros_like(pts)})
    # the one-step makers draw nothing
    F.make_fgsm(recording, ce, cfg, device="cpu")(pts, labels)
