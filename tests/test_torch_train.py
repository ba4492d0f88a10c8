"""The port's trainer (`hitadv_torch.train`) and train-mode BN against the
JAX package's (`hitadv_tpu.train`, `hitadv_tpu.nn.functional.bn_training`).

One numpy parameter tree per victim (the JAX init at 10 classes) feeds
both packages through `params_from_numpy`; the batches are numpy-seeded
synthetic clouds. The JAX side runs its plain XLA path, the port the CPU
path, where its kernels take their plain versions.

What agrees, and how closely. A train-mode forward is a function of the
whole batch: BN divides by the batch's standard deviation, and the
gradient through its statistics is a difference of nearly equal terms,
worst in PointNet's transform nets and PointNet++'s stages (both
packages' f32 roundings move a leaf's gradient by up to 3e-2 and 1e-1 of
its L2 norm there). Adam's first steps are close to ``-lr sign(g)``, so a
gradient entry within its rounding of 0 (every bias that feeds a BN: its
gradient is 0 in exact arithmetic, and rounding noise in either package)
moves its weight by ``lr`` in a sign that neither package decides. So
each step starts both packages from the same state (the port's tree and
Adam moments set to JAX's), and the step is held in two parts: the
port's gradient, leaf by leaf, against ``jax.grad`` of the same loss at
the same parameters (entries within rounding of 0 left out by `ZERO`),
and the port's new weights against optax's Adam update of the port's own
gradient from that state, entry by entry.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from hitadv_tpu import train as JT
from hitadv_tpu.data import synthetic_clouds
from hitadv_tpu.losses import cross_entropy_loss as jax_ce
from hitadv_tpu.losses import smoothed_cross_entropy_loss as jax_smooth
from hitadv_tpu.models import dgcnn as JD
from hitadv_tpu.models import geoa3_pointnet as JG3
from hitadv_tpu.models import pct as JC
from hitadv_tpu.models import pointconv as JPC
from hitadv_tpu.models import pointnet as JPN
from hitadv_tpu.models import pointnet2 as JP2
from hitadv_tpu.nn import functional as jnnF
from hitadv_tpu.ops import geometry as JG
from hitadv_tpu.utils import checkpoint as jckpt
from hitadv_torch import losses as L
from hitadv_torch import train as T
from hitadv_torch.attacks.base import AdamState
from hitadv_torch.convert import params_from_numpy
from hitadv_torch.models import DGCNNConfig, get_model
from hitadv_torch.nn import functional as F
from hitadv_torch.ops import geometry as G
from test_torch_kernels import one_torch_thread  # noqa: F401

LR = 1e-3
SMALL_DGCNN = dict(k=20, emb_dims=64)
# name -> (JAX init(key), JAX apply, port constructor keywords, B, N, key)
VICTIMS = {
    "pointnet": (lambda k: JPN.init(k, 10), JPN.apply, {}, 8, 64, 0),
    "dgcnn": (lambda k: JD.init(k, 10, cfg=JD.DGCNNConfig(**SMALL_DGCNN)),
              JD.make_apply(JD.DGCNNConfig(**SMALL_DGCNN)),
              dict(cfg=DGCNNConfig(**SMALL_DGCNN)), 8, 64, 0),
    "pointnet++": (lambda k: JP2.init(k, 10), JP2.apply, {}, 4, 512, 0),
    "pct": (lambda k: JC.init(k, 10), JC.apply, {}, 4, 512, 0),
    "pointconv": (lambda k: JPC.init(k, 10), JPC.apply, {}, 4, 512, 13),
    "geoa3_pointnet": (lambda k: JG3.init(k, 10), JG3.apply, {}, 8, 64, 0),
}
# the grouping indices each victim's train-mode forward computes, by the
# geometry function that returns them (compared before any value)
INDEX_FNS = {"dgcnn": "knn_idx", "pointnet++": "query_ball_point",
             "pct": "knn_idx", "pointconv": "knn_idx"}
# The tolerances of one step from the same state, by victim, each a few
# times above the reading on these clouds: the loss (relative), the logits
# (the largest error over the largest logit), the running statistics
# (absolute, beside `STAT_RTOL`) and a leaf's gradient (relative L2 over
# its entries above `ZERO`; the worst leaf of both steps read 2.8e-2
# (PointNet, stn.conv.bn0.scale), 1.9e-5, 9.7e-2 (PointNet++, bn2.bias),
# 7.9e-3, 1.5e-2, 1.2e-5; frozen GeoA3 6.7e-7). PointNet++'s are the
# loosest: its train-mode BN takes the statistics of 65536 grouped values
# a channel, which XLA's CPU sums in f32 in order (its mean off by 2.4e-6
# where the port's is off by 9e-8, against an f64 sum), and the division
# by the batch's standard deviation multiplies that.
TOLS = {"pointnet": (1e-5, 2e-4, 2e-6, 0.1),
        "dgcnn": (5e-6, 5e-5, 5e-7, 1e-4),
        "pointnet++": (5e-4, 5e-3, 1e-4, 0.2),
        "pct": (1e-5, 1e-4, 2e-6, 3e-2),
        "pointconv": (2e-4, 4e-3, 1e-4, 5e-2),
        "geoa3_pointnet": (5e-6, 5e-5, 5e-7, 1e-4)}
STAT_RTOL = 1e-4
# A gradient entry counts as within rounding of 0 when its JAX value is at
# most ZERO times the largest of the tree. The biases that feed a BN read
# up to 3.3e-5 of it (PointConv's density nets) and their two packages'
# values disagree wholly; every leaf they are compared in reads the
# limits above.
ZERO = 1e-4


@pytest.fixture(autouse=True)
def jax_backend():
    backend = JG.get_backend()
    JG.set_backend("xla")
    try:
        yield
    finally:
        JG.set_backend(backend)


class Step(NamedTuple):
    jlogits: np.ndarray
    jloss: float
    jgrad: dict          # JAX's gradient at the step's start, flat
    jflat: dict          # JAX's tree after the step, flat
    r: object            # the port's `StepResult`
    pflat: dict          # the port's tree after the step, flat
    adam: dict           # optax's update of the port's gradient, flat
    jidx: list           # JAX's grouping indices
    pidx: list           # the port's


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        *head, last = path.split(".")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _batches(name, steps=2, seed=15):
    *_, B, N, _ = VICTIMS[name]
    out = []
    for s in range(steps):
        pts, labels = synthetic_clouds(B, N, 10, seed=seed + s)
        out.append((pts[..., :3].copy(), labels.astype(np.int32)))
    return out


def _jax_tree(name):
    init, *_, key = VICTIMS[name]
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(key)))


def _port_model(name, tree):
    kw = VICTIMS[name][2]
    return get_model(name)(params=params_from_numpy(tree, "cpu"),
                           device="cpu", **kw)


def _jax_grad(name, frozen_bn=False):
    """A jitted train-mode forward and gradient of JAX's victim at the
    step's loss (the batch's mean cross-entropy): ``(params, x, y) ->
    (logits, the grouping indices it computed, gradient tree)``. The
    indices (`INDEX_FNS`) are recorded while it traces; ``frozen_bn`` runs
    the running statistics and records none."""
    fn = None if frozen_bn else INDEX_FNS.get(name)
    apply = VICTIMS[name][1]

    def loss(params, x, y):
        rec = []
        if fn:
            real = getattr(JG, fn)
            setattr(JG, fn, lambda *a, **k: rec.append(real(*a, **k))
                    or rec[-1])
        try:
            if frozen_bn:
                logits = apply(params, x)
            else:
                with jnnF.bn_training([]):
                    logits = apply(params, x)
        finally:
            if fn:
                setattr(JG, fn, real)
        return jnp.mean(jax_ce(logits, y)), (logits, rec)

    @jax.jit
    def run(params, x, y):
        (_, (logits, rec)), grads = jax.value_and_grad(
            loss, has_aux=True)(params, x, y)
        return logits, rec, grads
    return run


def _port_indices(name, model, x):
    """The port's grouping indices of a train-mode forward on ``x``."""
    fn = INDEX_FNS.get(name)
    if not fn:
        return []
    rec, real = [], getattr(G, fn)
    setattr(G, fn, lambda *a, **k: rec.append(real(*a, **k)) or rec[-1])
    try:
        with F.bn_training([]), torch.no_grad():
            model(torch.from_numpy(x))
    finally:
        setattr(G, fn, real)
    return [r.numpy() for r in rec]


def _sync(model, opt, jflat, jstate):
    """The port's model and Adam set to JAX's tree and optax state."""
    adam = jstate[0]
    mu, nu = _flat(jax.tree_util.tree_map(np.asarray, adam.mu)), _flat(
        jax.tree_util.tree_map(np.asarray, adam.nu))
    with torch.no_grad():
        for path, p in model.params.named_parameters():
            p.copy_(torch.from_numpy(jflat[path].copy()))
    opt.states = {k: AdamState(int(adam.count), torch.from_numpy(mu[k].copy()),
                               torch.from_numpy(nu[k].copy()))
                  for k in T.trainable(model)}


def _steps(name, tree, batches, frozen_bn=False):
    """Both packages' `make_train_step` over ``batches``, each step from the
    same state (the port's set to JAX's before it). Per step: (JAX's
    train-mode logits, loss, gradient and tree after it; the port's
    `StepResult` and tree after it; the grouping indices of both
    forwards)."""
    apply = VICTIMS[name][1]
    jopt = optax.adam(LR)
    jstep = JT.make_train_step(apply, jopt, frozen_bn=frozen_bn)
    update = jax.jit(lambda p, s, g: optax.apply_updates(
        p, jopt.update(g, s, p)[0]))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(params)
    model = _port_model(name, tree)
    opt = T.Adam(LR)
    step = T.make_train_step(model, opt, frozen_bn=frozen_bn)
    forward = _jax_grad(name, frozen_bn)
    out = []
    for x, y in batches:
        jlg, jidx, jgrad = forward(params, jnp.asarray(x), jnp.asarray(y))
        jlg, jidx = np.asarray(jlg), [np.asarray(i) for i in jidx]
        jgrad = _flat(jax.tree_util.tree_map(np.asarray, jgrad))
        pidx = [] if frozen_bn else _port_indices(name, model, x)
        before = (params, jstate)
        params, jstate, loss, _ = jstep(params, jstate, jnp.asarray(x),
                                        jnp.asarray(y))
        jflat = _flat(jax.tree_util.tree_map(np.asarray, params))
        r = step(torch.from_numpy(x), torch.from_numpy(y).long())
        pflat = _flat(_numpy(T.param_tree(model)))
        # optax's Adam update of the port's gradient from the same state
        pgrad = _unflat({k: r.grads[k].numpy() if k in r.grads
                         else np.zeros_like(v) for k, v in jgrad.items()})
        adam = _flat(jax.tree_util.tree_map(np.asarray, update(
            *before, jax.tree_util.tree_map(jnp.asarray, pgrad))))
        out.append(Step(jlg, float(loss), jgrad, jflat, r, pflat, adam,
                        jidx, pidx))
        _sync(model, opt, jflat, jstate)
    return out


def _numpy(tree):
    return ({k: _numpy(v) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.numpy().copy())


@pytest.fixture(scope="module")
def runs():
    """Both packages' two steps of every victim (`_steps`), run once for
    the module."""
    return {name: _steps(name, _jax_tree(name), _batches(name))
            for name in VICTIMS}


def _is_stat(path):
    return path.endswith((".mean", ".var"))


def _check_grads_and_weights(st, grad_tol):
    """The port's step against JAX's, leaf by leaf: its gradient within
    ``grad_tol`` (relative L2) of JAX's over the entries above `ZERO`, and
    its new weights optax's Adam update of its own gradient, within
    rounding; every trained weight within Adam's bound
    of ``2 lr`` of JAX's."""
    top = max(np.abs(st.jgrad[k]).max() for k in st.r.grads)
    for path, g in st.r.grads.items():
        want = st.jgrad[path]
        keep = np.abs(want) > ZERO * top
        if keep.any():
            diff = (g.numpy() - want)[keep]
            err = np.linalg.norm(diff) / np.linalg.norm(want[keep])
            assert err <= grad_tol, (path, err)
        # the update in another order (an ulp of lr, twice), then the sum
        np.testing.assert_allclose(
            st.pflat[path], st.adam[path], rtol=0,
            atol=np.spacing(np.abs(st.adam[path]).max())
            + 2 * np.spacing(np.float32(LR)), err_msg=path)
        d = np.abs(st.jflat[path] - st.pflat[path])
        assert d.max() <= 2 * LR * (1 + 1e-3), (path, d.max())


@pytest.mark.parametrize("name", list(VICTIMS))
def test_two_train_steps_match_jax(runs, name):
    for s, st in enumerate(runs[name], start=1):
        # the grouping indices first: a flipped neighbour moves the rest
        assert len(st.jidx) == len(st.pidx) == (
            4 if name == "dgcnn" else 2 if name in INDEX_FNS else 0)
        for a, b in zip(st.jidx, st.pidx):
            np.testing.assert_array_equal(a, b, err_msg=f"step {s}")
        loss_tol, logit_tol, stat_atol, grad_tol = TOLS[name]
        assert abs(float(st.r.loss) - st.jloss) <= loss_tol * abs(st.jloss), (
            s, float(st.r.loss), st.jloss)
        err = np.abs(st.r.logits.numpy() - st.jlogits).max() \
            / np.abs(st.jlogits).max()
        assert err <= logit_tol, (s, err)
        assert set(st.pflat) == set(st.jflat)
        for path in st.jflat:
            if _is_stat(path):
                np.testing.assert_allclose(st.pflat[path], st.jflat[path],
                                           atol=stat_atol, rtol=STAT_RTOL,
                                           err_msg=f"step {s} {path}")
        _check_grads_and_weights(st, grad_tol)


def test_frozen_bn_matches_jax_and_keeps_stats():
    """``frozen_bn=True``: the running statistics normalise the forward
    and stay as they were, in both packages."""
    name = "geoa3_pointnet"
    loss_tol, logit_tol, _, grad_tol = TOLS[name]
    tree = _jax_tree(name)
    start = _flat(tree)
    for st in _steps(name, tree, _batches(name), frozen_bn=True):
        assert st.r.stats == []
        assert abs(float(st.r.loss) - st.jloss) <= loss_tol * abs(st.jloss)
        assert np.abs(st.r.logits.numpy() - st.jlogits).max() \
            <= logit_tol * np.abs(st.jlogits).max()
        for path in st.jflat:
            if _is_stat(path):
                np.testing.assert_array_equal(st.pflat[path], start[path])
                np.testing.assert_array_equal(st.jflat[path], start[path])
        _check_grads_and_weights(st, grad_tol)


def test_train_mode_bn_two_steps_match_jax():
    """`F.batchnorm` inside `F.bn_training` against JAX's on [B, N, C] and
    [B, C] inputs, two steps with the EMA between: outputs and recorded
    statistics within 1e-6 relative (f32 means and variances summed in
    other orders)."""
    rng = np.random.RandomState(3)
    for shape in ((4, 17, 6), (8, 5)):
        C, m = shape[-1], 0.1
        p = {"scale": rng.rand(C).astype(np.float32) + 0.5,
             "bias": rng.randn(C).astype(np.float32),
             "mean": np.zeros(C, np.float32), "var": np.ones(C, np.float32)}
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
        for step in range(2):
            x = (rng.randn(*shape) * (step + 1) + 3).astype(np.float32)
            jrec, trec = [], []
            with jnnF.bn_training(jrec):
                jy = np.asarray(jnnF.batchnorm(jp, jnp.asarray(x)))
            with F.bn_training(trec):
                ty = F.batchnorm(tp, torch.from_numpy(x)).numpy()
            assert F.bn_is_training() is False and len(trec) == 1
            np.testing.assert_allclose(ty, jy, rtol=1e-6,
                                       atol=1e-6 * np.abs(jy).max())
            (_, jm, jv), (tbn, tm, tv) = jrec[0], trec[0]
            assert tbn is tp
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
            jp["mean"] = (1 - m) * jp["mean"] + m * jm
            jp["var"] = (1 - m) * jp["var"] + m * jv
            tp["mean"] = (1 - m) * tp["mean"] + m * tm
            tp["var"] = (1 - m) * tp["var"] + m * tv
        np.testing.assert_allclose(tp["mean"].numpy(), np.asarray(jp["mean"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tp["var"].numpy(), np.asarray(jp["var"]),
                                   rtol=1e-6)


def test_eval_mode_outside_the_context():
    """Outside `bn_training` BN uses the running statistics and the
    victims keep their fused eval forms, whatever their ``training``
    flag: `train()` switches nothing."""
    tree = _jax_tree("pointnet")
    model = _port_model("pointnet", tree)
    x = torch.from_numpy(_batches("pointnet", 1)[0][0])
    with torch.no_grad():
        want = model(x)
        model.train()
        got = model(x)
    assert torch.equal(want, got)
    assert not any(p.requires_grad for p in model.parameters())


def test_smoothed_cross_entropy_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 10).astype(np.float32) * 3
    y = rng.randint(0, 10, 6)
    for eps in (0.2, 0.0, 0.5):
        want = np.asarray(jax_smooth(jnp.asarray(logits), jnp.asarray(y),
                                     eps))
        got = L.smoothed_cross_entropy_loss(torch.from_numpy(logits),
                                            torch.from_numpy(y), eps)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        L.smoothed_cross_entropy_loss(torch.from_numpy(logits),
                                      torch.from_numpy(y), 0.0).numpy(),
        np.asarray(jax_ce(jnp.asarray(logits), jnp.asarray(y))), rtol=1e-6)


def test_adam_matches_optax():
    """`train.Adam` against ``optax.adam`` on the same gradients, three
    steps: the same f32 operations but for the update's order (``lr`` times
    the quotient, or the product divided), within an ulp of the weights."""
    rng = np.random.RandomState(6)
    w0 = rng.randn(5, 7).astype(np.float32)
    gs = [rng.randn(5, 7).astype(np.float32) * 10.0 ** -k for k in range(3)]
    opt = optax.adam(LR)
    jw, st = jnp.asarray(w0), opt.init(jnp.asarray(w0))
    tw, adam = torch.from_numpy(w0.copy()), T.Adam(LR)
    for g in gs:
        upd, st = opt.update(jnp.asarray(g), st, jw)
        jw = optax.apply_updates(jw, upd)
        adam.update({"w": tw}, {"w": torch.from_numpy(g)})
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                                   atol=np.spacing(np.abs(w0).max()))


def _recorded_batches(monkeypatch, module, wrap):
    """Replace ``module.make_train_step`` by one whose steps record the
    labels of their batches, and return that record."""
    seen = []
    real = module.make_train_step

    def make(*a, **k):
        inner = real(*a, **k)
        return wrap(inner, seen)
    monkeypatch.setattr(module, "make_train_step", make)
    return seen


def test_train_victim_batch_order_matches_jax(monkeypatch):
    """Both packages' `train_victim` hand their steps the same batches in
    the same order: ``RandomState(0)`` permutations, the last partial
    batch dropped."""
    M, B, N = 21, 4, 16
    rng = np.random.RandomState(7)
    clouds = rng.randn(M, N, 3).astype(np.float32)
    labels = np.arange(M).astype(np.int32)          # a label names a cloud

    def jwrap(inner, seen):
        def step(params, state, x, y):
            seen.append(np.asarray(y).tolist())
            return params, state, jnp.zeros(()), jnp.zeros(())
        return step

    def twrap(inner, seen):
        def step(x, y):
            seen.append(y.tolist())
            return T.StepResult(torch.zeros(()), torch.zeros(()), None, {},
                                [])
        return step

    jseen = _recorded_batches(monkeypatch, JT, jwrap)
    tseen = _recorded_batches(monkeypatch, T, twrap)
    JT.train_victim(lambda k: {"w": jnp.zeros(2)}, None, clouds, labels,
                    jax.random.PRNGKey(0), epochs=3, batch_size=B)
    T.train_victim(_port_model("pointnet", _jax_tree("pointnet")), clouds,
                   labels, epochs=3, batch_size=B)
    assert tseen == jseen and len(tseen) == 3 * (M // B)


def test_main_writes_a_tree_both_packages_read(tmp_path, capsys):
    """``train.main --device cpu`` trains and pickles its tree; the JAX
    package loads it, and its eval-mode logits agree with the port's on
    the same clouds."""
    out = str(tmp_path / "victim.pkl")
    model = T.main(["--model", "pointnet", "--epochs", "1", "--num_train",
                    "16", "--num_point", "64", "--num_class", "10",
                    "--batch_size", "8", "--out", out, "--device", "cpu",
                    "--seed", "2"])
    assert "epoch 0: acc" in capsys.readouterr().out
    tree = jckpt.load_params(out)
    x = synthetic_clouds(4, 64, 10, seed=9)[0][..., :3].copy()
    want = np.asarray(jax.jit(JPN.apply)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert not any(p.requires_grad for p in model.parameters())
    # the trained statistics moved from their initial (0, 1)
    assert np.abs(tree["bn1"]["mean"]).max() > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.main(["--out", out])
