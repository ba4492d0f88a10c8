"""The port's evaluation (`hitadv_torch.eval`, `evaluation`, `config`,
`utils`, `losses.geoa3.uniform_loss`, `losses.distance.curv_std_dist`)
against the JAX package's on the CPU.

Clouds come from numpy seeds; the JAX side runs its XLA path, whose
ball query and kNN take matmul distances where the port takes the
elementwise form (ROADMAP §3), so each metric test asserts first that
the indices agree on its clouds.
"""

import argparse
import dataclasses
import importlib
import itertools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu import config as JCFG
from hitadv_tpu import evaluation as JE
from hitadv_tpu import losses as JL
from hitadv_tpu.data import synthetic_batches, synthetic_clouds
from hitadv_tpu.models import pointnet as JP
from hitadv_tpu.ops import geometry as JG
from hitadv_tpu.utils import checkpoint as JCK
from hitadv_torch import config as CFG
from hitadv_torch import eval as EV
from hitadv_torch import evaluation as E
from hitadv_torch import losses as L
from hitadv_torch.attacks import AttackResult
from hitadv_torch.convert import params_from_numpy
from hitadv_torch.losses.geoa3 import uniform_disks
from hitadv_torch.models import PointNet, get_model
from hitadv_torch.ops import geometry as G
from hitadv_torch.utils import EvalProgress
from hitadv_torch.utils import checkpoint as CK
from test_torch_kernels import one_torch_thread  # noqa: F401

PKL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "asr_victim_params.pkl")


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
def trained():
    """The committed trained 10-class victim (64-point clouds) on both
    sides, and 16 of its clouds with a small perturbation as the
    adversarial ones."""
    tree = CK.load_params(PKL)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    port = PointNet(params=params_from_numpy(tree, "cpu"), device="cpu")
    pts, labels = synthetic_clouds(16, 64, num_classes=10, seed=99)
    adv = pts[..., :3] + 0.02 * np.random.RandomState(5).randn(
        16, 64, 3).astype(np.float32)
    return jparams, port, pts, adv, labels


def _disk_indices(geo, cloud, k):
    """The uniformity metric's ball-query and in-disk kNN indices through
    ``geo`` (either package's geometry module), as `uniform_loss` takes
    them."""
    B, n, _ = cloud.shape
    S = int(n * 0.05)
    centres = geo.index_points(cloud, geo.farthest_point_sample(
        cloud, S))                                 # both start at index 0
    out = []
    for _, ns, r, _ in uniform_disks(n):
        idx = geo.query_ball_point(r, ns, cloud, centres)
        flat = geo.index_points(cloud, idx).reshape(B * S, ns, 3)
        out += [idx, geo.knn_points(flat, flat, min(k + 1, ns)).idx]
    return [np.asarray(i) for i in out]


@pytest.mark.parametrize("N,k", [(256, 5), (64, 2)])
def test_uniform_loss_matches_jax(N, k):
    cloud = np.random.RandomState(40).randn(3, N, 3).astype(np.float32)
    cloud /= np.linalg.norm(cloud, axis=-1, keepdims=True)   # on a sphere
    for want, got in zip(_disk_indices(JG, jnp.asarray(cloud), k),
                         _disk_indices(G, torch.from_numpy(cloud), k)):
        np.testing.assert_array_equal(got, want)
    want = float(JL.uniform_loss(jnp.asarray(cloud), k=k))
    got = L.uniform_loss(torch.from_numpy(cloud), k=k)
    assert got.shape == () and np.isfinite(want)
    # both packages form the squared spacings as |q|^2 - 2 q.p + |p|^2 in
    # f32 (the XLA path by a matmul, the port elementwise): ~1e-7 absolute
    # on squares of ~3e-3, ~2e-5 relative on a spacing, in other roundings
    # on the two sides; the metric squares the spacings' small deviation
    # from the uniform spacing, which amplifies that ~50 times
    np.testing.assert_allclose(got.item(), want, rtol=5e-3)


def test_curv_std_dist_matches_jax(trained):
    _, _, pts, adv, _ = trained
    ori, normal = pts[..., :3], pts[..., 3:]
    for cloud in (ori, adv):
        want = np.asarray(JG.knn_indices(jnp.asarray(cloud), 4)[1])
        got = G.knn_indices(torch.from_numpy(cloud), 4)[1]
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(JL.curv_std_dist(*(jnp.asarray(a) for a in (
        ori, adv, normal)), k=4))
    got = L.curv_std_dist(*(torch.from_numpy(np.ascontiguousarray(a))
                            for a in (ori, adv, normal)), k=4)
    assert got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_batch_metrics_match_jax(trained):
    """`evaluation._batch_metrics` on the trained victim: the three
    imperceptibility metrics and the three counts, against the JAX
    package's jitted program on the same clouds."""
    jparams, port, pts, adv, labels = trained
    ori, normal = pts[..., :3], np.ascontiguousarray(pts[..., 3:])
    want = JE._batch_metrics(lambda x: JP.apply(jparams, x),
                             jnp.asarray(ori), jnp.asarray(adv),
                             jnp.asarray(normal), jnp.asarray(labels), 5)
    got = E._batch_metrics(port, torch.from_numpy(np.ascontiguousarray(ori)),
                           torch.from_numpy(adv), torch.from_numpy(normal),
                           torch.from_numpy(labels).long(), 5)
    assert got.dtype == torch.float64 and got.shape == (6,)
    want = np.array([float(w) for w in want])
    np.testing.assert_allclose(got[:3].numpy(), want[:3], rtol=1e-4)
    np.testing.assert_array_equal(got[3:].numpy(), want[3:])
    assert want[4] > 0                          # some clouds are correct


def test_eval_asr_resume_matches_uninterrupted(trained, tmp_path):
    """A sweep cut after two of four batches and resumed from its progress
    file gives what the uninterrupted sweep gives: each batch's draws
    depend on the run's seed and the batch alone."""
    port = trained[1]

    def attack(points, labels, gen):
        adv = points[..., :3] + 0.05 * torch.randn(points[..., :3].shape,
                                                   generator=gen)
        pred = torch.argmax(port(adv), dim=-1)
        return AttackResult(adv_points=adv, success=pred != labels,
                            pred=pred)

    def batches():
        return synthetic_batches(4, 4, num_points=64, num_classes=10,
                                 seed=30)

    kw = dict(seed=3, uniform_k=2, verbose=False, device="cpu")
    want = E.eval_asr(port, attack, batches(), **kw)
    path = str(tmp_path / "progress.pkl")
    E.eval_asr(port, attack, itertools.islice(batches(), 2),
               progress=EvalProgress(path), **kw)
    prog = EvalProgress(path)
    assert prog.next_batch == 2
    got = E.eval_asr(port, attack, batches(), progress=prog, **kw)
    assert got == want
    assert want["total"] == 16 and 0 < want["clean_correct"] <= 16
    other = E.eval_asr(port, attack, batches(), **dict(kw, seed=4))
    assert other["knn_dist"] != want["knn_dist"]


def test_config_from_args_round_trip():
    parser = argparse.ArgumentParser()
    CFG.add_config_flags(parser)
    assert CFG.config_from_args(parser.parse_args([])) == CFG.EvalConfig()
    cfg = CFG.EvalConfig(dataset="synthetic", batch_size=8, bf16=True,
                         use_normals=False, checkpoint="victim.pkl",
                         step_size=0.25, max_batches=3, kappa=2.5,
                         dist_func="chamfer", device="cpu")
    argv = []
    for f in dataclasses.fields(cfg):
        if getattr(cfg, f.name) is not None:
            argv += [f"--{f.name}", str(getattr(cfg, f.name))]
    assert CFG.config_from_args(parser.parse_args(argv)) == cfg
    # the JAX package's fields and defaults, and one more: the device
    jfields = {f.name: f.default for f in dataclasses.fields(
        JCFG.EvalConfig)}
    fields = {f.name: f.default for f in dataclasses.fields(CFG.EvalConfig)}
    assert fields.pop("device") == "cuda"
    assert fields == jfields
    assert EV.parse_args(["--k", "7"])[0].k == 7


def _module_tree(module):
    """A model's registered parameters as nested dicts of numpy arrays."""
    if isinstance(module, torch.nn.ParameterDict):
        return {k: v.detach().numpy() for k, v in module.items()}
    return {k: _module_tree(v) for k, v in module.items()}


def _synthetic_state_dict(tree, spec, rng):
    """A torch state dict in the reference's layout for ``spec``, with the
    shapes of ``tree`` and random values (BN statistics included, and a
    ``num_batches_tracked`` entry per BN, as torch writes them)."""
    sd = {}
    for path, (prefix, kind) in spec.items():
        leaf = tree
        for part in path.split("/"):
            leaf = leaf[part]
        if kind == "bn":
            c = leaf["scale"].shape[0]
            sd.update({f"{prefix}.weight": 1 + 0.2 * rng.randn(c),
                       f"{prefix}.bias": 0.1 * rng.randn(c),
                       f"{prefix}.running_mean": 0.1 * rng.randn(c),
                       f"{prefix}.running_var": 0.5 + rng.rand(c)})
            sd[f"{prefix}.num_batches_tracked"] = np.array(7)
            continue
        cin, cout = leaf["w"].shape
        w = rng.randn(cout, cin) / np.sqrt(cin)
        sd[f"{prefix}.weight"] = w[..., None] if kind == "conv" else w
        if "b" in leaf:
            sd[f"{prefix}.bias"] = 0.1 * rng.randn(cout)
    return {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
            for k, v in sd.items()}


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("name,module,N", [
    ("pointnet", "pointnet", 1024), ("dgcnn", "dgcnn", 256),
    ("pointnet++", "pointnet2", 1024), ("pct", "pct", 1024),
    ("pointconv", "pointconv", 1024)])
def test_convert_state_dict_matches_jax(name, module, N, tmp_path):
    """A reference-layout torch checkpoint of each victim: the port's
    ``TORCH_SPEC`` and `convert_state_dict` give the JAX package's tree,
    and `eval.build_model` on the checkpoint gives the JAX logits."""
    port_mod = importlib.import_module(f"hitadv_torch.models.{module}")
    jax_mod = importlib.import_module(f"hitadv_tpu.models.{module}")
    assert port_mod.TORCH_SPEC == jax_mod.TORCH_SPEC
    shapes = _module_tree(get_model(name)(10, device="cpu").params)
    sd = _synthetic_state_dict(shapes, port_mod.TORCH_SPEC,
                               np.random.RandomState(41))
    got = dict(_leaves(CK.convert_state_dict(sd, port_mod.TORCH_SPEC)))
    want = dict(_leaves(JCK.convert_state_dict(sd, jax_mod.TORCH_SPEC)))
    assert got.keys() == want.keys() == dict(_leaves(shapes)).keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the checkpoint as the reference writes it, through `build_model`
    path = str(tmp_path / "victim.pth")
    torch.save({"epoch": 3, "model_state_dict": {
        k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    loaded = CK.load_torch_state_dict(path)
    assert all(np.array_equal(loaded[k], sd[k]) for k in sd)
    model = EV.build_model(CFG.EvalConfig(model=name, checkpoint=path,
                                          k=20, device="cpu"))
    x = np.random.RandomState(1).randn(1, N, 3).astype(np.float32) * .5
    jtree = JCK.convert_state_dict(sd, jax_mod.TORCH_SPEC)
    want_logits = np.asarray(jax_mod.apply(jtree, jnp.asarray(x)))
    with torch.no_grad():
        got_logits = model(torch.from_numpy(x)).numpy()
    assert got_logits.shape == (1, 10)
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-4,
                               atol=1e-5)


def test_save_and_load_params_round_trip(trained, tmp_path):
    """`save_params` pickles a model's tensors as the numpy tree that
    `load_params` (and the JAX package's loader) reads back."""
    port = trained[1]
    path = str(tmp_path / "victim.pkl")
    CK.save_params(path, _module_tree(port.params))
    back = CK.load_params(path)
    tree = CK.load_params(PKL)
    assert dict(_leaves(back)).keys() == dict(_leaves(tree)).keys()
    for (k, a), (_, b) in zip(_leaves(back), _leaves(tree)):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b, err_msg=k)
    jtree = JCK.load_params(path)
    np.testing.assert_array_equal(np.asarray(jtree["conv3"]["w"]),
                                  tree["conv3"]["w"])


TRAINED_ARGV = ["--dataset", "synthetic", "--batch_size", "16",
                "--synthetic_size", "32", "--num_point", "64",
                "--num_class", "10", "--checkpoint", PKL, "--seed", "99",
                "--budget", "0.2", "--log_dir", ""]


@pytest.mark.parametrize("attack,extra", [
    ("HiT-ADV", ["--binary_step", "2", "--num_iter", "8", "--central_num",
                 "16", "--total_central_num", "24", "--curv_loss_knn",
                 "8"]),
    ("CW-UKNN", []),
    ("CW-PerturbT", ["--binary_step", "2", "--num_iter", "8"]),
    ("CW-UPerturb", ["--binary_step", "2", "--num_iter", "8"]),
    ("CW-UPerturb", ["--binary_step", "2", "--num_iter", "8",
                     "--dist_func", "chamfer"])])
def test_main_asr_matches_jax_main(attack, extra, monkeypatch):
    """`hitadv_torch.eval.main` with ``--device cpu`` on the trained
    victim against the JAX package's `main` on the same arguments: the
    same clean-correct clouds, and ASR within one example (the two draw
    their random starts from different generators). CW-UKNN runs its
    fixed iteration count, cut here to 40 on both sides; CW-Perturb(T),
    CW-UPerturb and its Chamfer form run 2 x 8."""
    from hitadv_tpu import attacks as JA
    from hitadv_tpu.eval import main as jax_main
    from hitadv_torch import attacks as A

    for mod in (JA, A):
        real = mod.CWKNNConfig
        monkeypatch.setattr(mod, "CWKNNConfig", lambda real=real, **kw:
                            real(num_iter=40, **kw))
    argv = TRAINED_ARGV + ["--attack_type", attack] + extra
    want = jax_main(argv)
    got = EV.main(argv + ["--device", "cpu"])
    assert got["clean_correct"] == want["clean_correct"] > 0
    assert got["total"] == want["total"] == 32
    assert abs(got["asr"] - want["asr"]) * want["clean_correct"] <= 1 + 1e-6
    for key in ("knn_dist", "uniform_dist", "curv_std_dist"):
        assert np.isfinite(got[key]), key


@pytest.mark.parametrize("argv,error,match", [
    (["--dataset", "ModelNet", "--attack_type", "Add"], ValueError,
     "--data_path"),
    (["--dataset", "synthetic", "--restarts", "2", "--attack_type", "AdvPC",
      "--n_devices", "2"], ValueError, "mutually exclusive"),
    (["--attack_type", "cw_lpips"], ValueError, "--data_path"),
    (["--dataset", "ModelNet"], ValueError, "--data_path"),
    (["--dataset", "synthetic", "--n_devices", "2", "--attack_type",
      "add_cluster", "--restarts", "3"], ValueError, "mutually exclusive"),
    (["--dataset", "synthetic", "--restarts", "4", "--sp_devices", "2"],
     ValueError, "mutually exclusive"),
    (["--dataset", "synthetic", "--n_devices", "8", "--device", "cuda"],
     RuntimeError, "no CUDA device"),
    (["--dataset", "synthetic", "--sp_devices", "2", "--dist_func",
      "chamfer", "--attack_type", "cw-perturb", "--n_devices", "2"],
     ValueError, "mutually exclusive"),
    (["--dataset", "ShapeNetPart"], ValueError, "--data_path")])
def test_unported_settings_raise(argv, error, match):
    """The settings the port once refused now run; what still raises is
    the JAX `eval`'s refusals of the parallel flags together (its
    messages), a real dataset without ``--data_path`` (the JAX `eval`
    runs synthetic clouds instead: a deliberate difference) and a card
    asked for where there is none."""
    argv = argv + ["--log_dir", ""]
    if "--device" not in argv:
        argv += ["--device", "cpu"]
    with pytest.raises(error, match=match):
        EV.main(argv)


def test_main_dgcnn_past_k64_on_cpu():
    """``--model dgcnn --k 65`` (DGCNN's and the uniform metric's k) runs
    on the CPU: the kNN's cap of 64 was the card kernel's list length,
    which its continuation passes now go past (ROADMAP §3 fault 1)."""
    m = EV.main(["--dataset", "synthetic", "--model", "dgcnn", "--k", "65",
                 "--batch_size", "2", "--synthetic_size", "2",
                 "--num_point", "128", "--binary_step", "1", "--num_iter",
                 "2", "--central_num", "8", "--total_central_num", "16",
                 "--curv_loss_knn", "8", "--device", "cpu", "--log_dir",
                 ""])
    assert m["total"] == 2
    for key in ("knn_dist", "uniform_dist", "curv_std_dist"):
        assert np.isfinite(m[key]), key


def test_cuda_without_a_card_raises():
    # decided inside the test: every test worker imports this file
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EV.main(["--dataset", "synthetic", "--log_dir", ""])


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="unknown attack_type"):
        EV.build_attack(CFG.EvalConfig(attack_type="nope", dataset="synthetic",
                                       device="cpu"),
                        None)
    with pytest.raises(ValueError, match="dist_func"):
        EV.build_attack(CFG.EvalConfig(attack_type="CW-UPerturb",
                                       dataset="synthetic",
                                       dist_func="emd", device="cpu"), None)
