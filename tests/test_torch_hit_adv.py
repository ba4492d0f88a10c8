"""The port's HiT-ADV and its losses against `hitadv_tpu`.

Both packages get the same numpy inputs, the same parameter tree (through
`params_from_numpy`) and, for whole attacks, the same pinned random
draws (`init_overrides`, FPS from index 0). The port runs on the CPU.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu import losses as JL
from hitadv_tpu.attacks import base as JB
from hitadv_tpu.attacks import hit_adv as JH
from hitadv_tpu.data import synthetic_clouds
from hitadv_tpu.losses import distance as JD
from hitadv_tpu.models import pointnet as JP
from hitadv_tpu.ops import geometry as JG
from hitadv_torch import losses as L
from hitadv_torch.attacks import base as B
from hitadv_torch.attacks import hit_adv as H
from hitadv_torch.convert import load_numpy_params, params_from_numpy
from hitadv_torch.data import synthetic_clouds as port_synthetic_clouds
from hitadv_torch.models import PointNet
from test_torch_kernels import one_torch_thread  # noqa: F401

PKL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "asr_victim_params.pkl")
SMALL = dict(binary_step=2, num_iter=8, central_num=16, total_central_num=32,
             curv_loss_knn=8)                 # tests/test_hit_adv.py:19


@pytest.fixture(autouse=True)
def xla_backend():
    """The JAX side on its plain XLA path; the knob is restored after."""
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
    return jax.jit(lambda x: JP.apply(params, x)), model


def _clean_labels(jfn, pts):
    """The victim's own predictions: untargeted success then needs a flip."""
    return np.asarray(jnp.argmax(jfn(jnp.asarray(pts[..., :3])), -1),
                      np.int32)


def test_synthetic_copy_is_identical():
    for args in [(3, 50), (2, 70, 10, 5)]:
        a, la = synthetic_clouds(*args)
        b, lb = port_synthetic_clouds(*args)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("kappa", [0.0, 30.0])
def test_margin_and_ce_losses(kappa):
    rng = np.random.RandomState(0)
    logits = rng.randn(6, 10).astype(np.float32) * 3
    logits[0, 3] = logits[0, 5]                   # a tie in the other-max
    t = rng.randint(0, 10, 6).astype(np.int32)
    pairs = [
        (JL.untargeted_logits_adv_loss, L.untargeted_logits_adv_loss),
        (JL.logits_adv_loss, L.logits_adv_loss),
    ]
    lt, tt = torch.from_numpy(logits), torch.from_numpy(t)
    for jf, tf in pairs:
        np.testing.assert_allclose(
            tf(lt, tt, kappa).numpy(),
            np.asarray(jf(jnp.asarray(logits), jnp.asarray(t), kappa)),
            rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        L.cross_entropy_loss(lt, tt).numpy(),
        np.asarray(JL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(t))),
        rtol=1e-6, atol=1e-6)
    sel = B.make_adv_fn("logits", kappa=kappa)
    np.testing.assert_allclose(sel(lt, tt).numpy(),
                               L.untargeted_logits_adv_loss(lt, tt, kappa))
    sel = B.make_adv_fn("logits", kappa=kappa, targeted=True)
    np.testing.assert_allclose(sel(lt, tt).numpy(),
                               L.logits_adv_loss(lt, tt, kappa))
    assert B.make_adv_fn("cross_entropy") is L.cross_entropy_loss
    with pytest.raises(ValueError):
        B.make_adv_fn("hinge")


def test_adam_twenty_steps():
    rng = np.random.RandomState(1)
    p0 = rng.randn(3, 5).astype(np.float32)
    grads = rng.randn(20, 3, 5).astype(np.float32)
    jp, js = jnp.asarray(p0), JB.adam_init(jnp.asarray(p0))
    tp, ts = torch.from_numpy(p0), B.adam_init(torch.from_numpy(p0))
    for g in grads:
        jp, js = JB.adam_update(jnp.asarray(g), js, jp, 0.05)
        tp, ts = B.adam_update(torch.from_numpy(g), ts, tp, 0.05)
    assert ts.step == int(js.step) == 20
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ts.nu.numpy(), np.asarray(js.nu), rtol=1e-6)


def test_best_state_and_binary_search():
    rng = np.random.RandomState(2)
    adv = rng.randn(4, 5, 3).astype(np.float32)
    dist = np.array([0.5, 2.0, 0.1, 3.0], np.float32)
    ok = np.array([True, True, False, True])
    pred = np.array([1, 2, 3, 4], np.int32)
    jbest = JB.update_best(JB.BestState.init(jnp.asarray(adv)),
                           jnp.asarray(ok), jnp.asarray(dist),
                           jnp.asarray(pred), jnp.asarray(adv))
    tbest = B.update_best(B.BestState.init(torch.from_numpy(adv)),
                          torch.from_numpy(ok), torch.from_numpy(dist),
                          torch.from_numpy(pred), torch.from_numpy(adv))
    for a, b in zip(tbest, jbest):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    lo, up, w = (rng.rand(4).astype(np.float32) for _ in range(3))
    got = B.binary_search_update(torch.from_numpy(ok), *(torch.from_numpy(v)
                                                         for v in (lo, up, w)))
    want = JB.binary_search_update(jnp.asarray(ok), jnp.asarray(lo),
                                   jnp.asarray(up), jnp.asarray(w))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)


def test_kappa_and_kappa_std():
    pts, _ = synthetic_clouds(2, 100, seed=4)
    pc, nrm = pts[..., :3], pts[..., 3:]
    for jf, tf, k in [(JD.get_kappa, L.get_kappa, 8),
                      (JD.get_kappa_std, L.get_kappa_std, 6)]:
        np.testing.assert_allclose(
            tf(torch.from_numpy(pc), torch.from_numpy(nrm), k=k).numpy(),
            np.asarray(jf(jnp.asarray(pc), jnp.asarray(nrm), k=k)),
            rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def centrals(victims):
    jfn, model = victims
    cfg = JH.HiTADVConfig(**SMALL)
    pts, _ = synthetic_clouds(3, 130, seed=5)
    labels = _clean_labels(jfn, pts)
    want = jax.jit(lambda p, l: JH.prepare_centrals(jfn, cfg, p, l))(
        jnp.asarray(pts), jnp.asarray(labels))
    got = H.prepare_centrals(model, H.HiTADVConfig(**SMALL),
                             torch.from_numpy(pts),
                             torch.tensor(labels).long())
    return pts, labels, [np.asarray(w) for w in want], got


def test_prepare_centrals_fixed_fps_start(centrals):
    _, _, (w_ori, w_cp, w_ks), (ori, cp, ks) = centrals
    np.testing.assert_array_equal(ori.numpy(), w_ori)
    np.testing.assert_allclose(cp.numpy(), w_cp, rtol=0, atol=1e-7)
    np.testing.assert_allclose(ks.numpy(), w_ks, rtol=1e-5, atol=1e-6)


def test_one_inner_iteration_gradient(victims, centrals):
    """Adam's first moment after one step is 0.1 * grad: compare both
    groups' gradients, and the deformed cloud, on identical inputs."""
    jfn, model = victims
    pts, labels, (ori, cp, ks), _ = centrals
    Bn, Cn = ori.shape[0], SMALL["central_num"]
    rng = np.random.RandomState(6)
    pert0 = (0.55 * rng.rand(Bn, Cn, 3)).astype(np.float32)
    delta0 = (0.1 + 1.1 * rng.rand(Bn, Cn)).astype(np.float32)
    weight = np.full(Bn, 10.0, np.float32)
    adv_fn = JB.make_adv_fn("logits", kappa=30.0)
    jcfg, tcfg = JH.HiTADVConfig(**SMALL), H.HiTADVConfig(**SMALL)

    inner = JH.make_inner_iter(jfn, adv_fn, jcfg, jnp.asarray(ori),
                               jnp.asarray(labels), jnp.asarray(cp),
                               jnp.asarray(ks))
    jp, jd = jnp.asarray(pert0), jnp.asarray(delta0)
    jbest = JB.BestState.init(jnp.asarray(ori))
    carry = (jp, jd, JB.adam_init(jp), JB.adam_init(jd), jnp.asarray(weight),
             jbest, jbest, jnp.zeros_like(jnp.asarray(ori)))
    jnew, _ = jax.jit(inner)(carry, None)

    t = torch.tensor
    tinner = H.make_inner_iter(model, B.make_adv_fn("logits", kappa=30.0),
                               tcfg, t(ori), t(labels).long(), t(cp), t(ks))
    tp, td = t(pert0), t(delta0)
    tbest = B.BestState.init(t(ori))
    tnew = tinner(H.InnerState(pert=tp, delta=td, opt_p=B.adam_init(tp),
                               opt_d=B.adam_init(td), weight=t(weight),
                               best=tbest, o_best=tbest,
                               last=torch.zeros_like(t(ori))))
    np.testing.assert_allclose(tnew.opt_p.mu.numpy() / 0.1,
                               np.asarray(jnew[2].mu) / 0.1,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tnew.opt_d.mu.numpy() / 0.1,
                               np.asarray(jnew[3].mu) / 0.1,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tnew.last.numpy(), np.asarray(jnew[7]),
                               rtol=1e-5, atol=1e-6)


def _overrides(seed, S, Bn, Cn, budget):
    d = np.random.RandomState(seed)
    return {"pert": (d.rand(S, Bn, Cn, 3) * budget).astype(np.float32),
            "delta": (0.1 + d.rand(S, Bn, Cn) * 1.1).astype(np.float32)}


def test_pinned_draw_attack_matches(victims):
    jfn, model = victims
    pts, _ = synthetic_clouds(4, 128, seed=3)
    labels = _clean_labels(jfn, pts)
    ov = _overrides(11, SMALL["binary_step"], 4, SMALL["central_num"], 0.55)
    adv_fn = JB.make_adv_fn("logits", kappa=30.0, targeted=False)
    want = JH.make_hit_adv(jfn, adv_fn, JH.HiTADVConfig(**SMALL),
                           init_overrides=ov)(
        jnp.asarray(pts), jnp.asarray(labels), jax.random.PRNGKey(0))
    got = H.make_hit_adv(model, B.make_adv_fn("logits", kappa=30.0),
                         H.HiTADVConfig(**SMALL), init_overrides=ov,
                         device="cpu")(pts, labels)
    # f32 on both sides in other op orders: the trajectories drift
    # ~1e-6 per iteration, amplified by Adam's normalised steps
    np.testing.assert_allclose(got.adv_points.numpy(),
                               np.asarray(want.adv_points), atol=2e-3)
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))


def test_trained_victim_asr_matches_jax_run():
    """ASR on the committed trained victim, same pinned draws on both
    sides (tests/test_asr_regression.py's configuration), within one
    example of the JAX run."""
    tree = load_numpy_params(PKL)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jfn = jax.jit(lambda x: JP.apply(params, x))
    model = PointNet(params=params_from_numpy(tree, "cpu"), device="cpu")
    pts, labels = synthetic_clouds(64, 64, num_classes=10, seed=99)
    clean = np.asarray(jnp.argmax(jfn(jnp.asarray(pts[..., :3])), -1))
    with torch.no_grad():
        tclean = model(torch.from_numpy(pts[..., :3])).argmax(-1).numpy()
    np.testing.assert_array_equal(tclean, clean)
    mask = clean == labels
    kw = dict(binary_step=3, num_iter=20, central_num=16,
              total_central_num=24, curv_loss_knn=8, budget=0.2)
    ov = _overrides(5, 3, 64, 16, 0.2)
    want = JH.make_hit_adv(jfn, JB.make_adv_fn("logits", kappa=30.0),
                           JH.HiTADVConfig(**kw), init_overrides=ov)(
        jnp.asarray(pts), jnp.asarray(labels), jax.random.PRNGKey(0))
    got = H.make_hit_adv(model, B.make_adv_fn("logits", kappa=30.0),
                         H.HiTADVConfig(**kw), init_overrides=ov,
                         device="cpu")(pts, labels)
    flips_j = int(((np.asarray(want.pred) != labels) & mask).sum())
    flips_t = int(((got.pred.numpy() != labels) & mask).sum())
    assert 0.2 < flips_j / mask.sum() < 0.9
    assert abs(flips_t - flips_j) <= 1, (flips_t, flips_j, mask.sum())


def test_attack_needs_a_generator_unless_pinned(victims):
    _, model = victims
    attack = H.make_hit_adv(model, B.make_adv_fn("logits", kappa=30.0),
                            H.HiTADVConfig(**SMALL), device="cpu")
    pts, labels = synthetic_clouds(2, 64, seed=8)
    with pytest.raises(ValueError, match="Generator"):
        attack(pts, labels)
    a = attack(pts, labels, torch.Generator().manual_seed(2))
    b = attack(pts, labels, torch.Generator().manual_seed(2))
    assert torch.equal(a.adv_points, b.adv_points)
    assert (a.adv_points - torch.from_numpy(pts[..., :3])).abs().max() \
        <= 0.55 + 1e-4


def test_kernel_blend_matches_field_blend(victims):
    """``blend="kernel"`` (the blend-from-field pair on the transposed
    field) against ``blend="field"`` (exp + einsum), the same pinned
    draws, at the SMALL config."""
    _, model = victims
    pts, _ = synthetic_clouds(3, 128, seed=9)
    with torch.no_grad():
        labels = model(torch.from_numpy(pts[..., :3])).argmax(-1).numpy()
    ov = _overrides(13, SMALL["binary_step"], 3, SMALL["central_num"], 0.55)
    out = {blend: H.make_hit_adv(model, B.make_adv_fn("logits", kappa=30.0),
                                 H.HiTADVConfig(**SMALL), init_overrides=ov,
                                 device="cpu", blend=blend)(pts, labels)
           for blend in ("field", "kernel")}
    # the same ker on both sides; num and deno summed in another order
    # (einsum in f32 against f64 sums), ~1e-7 per blend, carried through
    # 16 Adam iterations: 6e-8 apart on the CPU
    np.testing.assert_allclose(out["kernel"].adv_points.numpy(),
                               out["field"].adv_points.numpy(), atol=1e-5)
    np.testing.assert_array_equal(out["kernel"].success.numpy(),
                                  out["field"].success.numpy())


def test_blend_must_be_field_or_kernel(victims, centrals):
    _, model = victims
    adv_fn = B.make_adv_fn("logits", kappa=30.0)
    for bad in ("pallas", "xla", "auto", "", None):
        with pytest.raises(ValueError, match="blend"):
            H.make_hit_adv(model, adv_fn, H.HiTADVConfig(**SMALL),
                           device="cpu", blend=bad)
    _, labels, (ori, cp, ks), _ = centrals
    t = torch.tensor
    with pytest.raises(ValueError, match="blend"):
        H.make_inner_iter(model, adv_fn, H.HiTADVConfig(**SMALL), t(ori),
                          t(labels).long(), t(cp), t(ks), blend="pallas")
