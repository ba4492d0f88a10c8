"""The attacks and settings that `hitadv_torch.eval` gained with the FGM
family, SaliencyDrop, the defenses, GeoA3, the Add attacks, the
autoencoder attacks and CW-LPIPS, against the JAX package's `main` on the
CPU, and the registry's bookkeeping."""

import os

import numpy as np
import jax
import pytest

from hitadv_tpu.models import autoencoder as JAE
from hitadv_tpu.models import geoa3_pointnet as JPN
from hitadv_tpu.ops import geometry as JG
from hitadv_tpu.utils import checkpoint as JCK
from hitadv_torch import config as CFG
from hitadv_torch import eval as EV
from hitadv_torch.models import PointNet
from test_torch_kernels import one_torch_thread  # noqa: F401

PKL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "asr_victim_params.pkl")
# the trained 10-class PointNet of `tests/data`, two batches of 16 clouds
# of 64 points (as `test_torch_eval.py`'s TRAINED_ARGV)
TRAINED = ["--dataset", "synthetic", "--batch_size", "16",
           "--synthetic_size", "32", "--num_point", "64", "--num_class",
           "10", "--checkpoint", PKL, "--seed", "99", "--budget", "0.2",
           "--log_dir", ""]


@pytest.fixture(autouse=True)
def xla_backend():
    prev = JG.get_backend()
    JG.set_backend("xla")
    try:
        yield
    finally:
        JG.set_backend(prev)


@pytest.fixture(scope="module")
def geoa3_victim(tmp_path_factory):
    """A 10-class GeoA3 PointNet drawn by the JAX package, pickled for
    both packages' ``--checkpoint``."""
    path = str(tmp_path_factory.mktemp("geoa3") / "geoa3_pointnet.pkl")
    JCK.save_params(path, jax.jit(JPN.init, static_argnums=1)(
        jax.random.PRNGKey(5), 10))
    return path


def _against_jax(argv, judged_by_own_draws=False):
    """Both `main`s on ``argv``: the same clean-correct count, and ASR
    within one example. A judging defense of random draws
    (``judged_by_own_draws``) judges each package by its own draws: the
    clean-correct counts and the flipped counts within one example."""
    from hitadv_tpu.eval import main as jax_main

    want = jax_main(argv)
    got = EV.main(argv + ["--device", "cpu"])
    assert got["total"] == want["total"]
    assert want["clean_correct"] > 0
    if judged_by_own_draws:
        assert abs(got["clean_correct"] - want["clean_correct"]) <= 1
        flipped = [m["asr"] * m["clean_correct"] for m in (got, want)]
        assert abs(flipped[0] - flipped[1]) <= 1 + 1e-6
    else:
        assert got["clean_correct"] == want["clean_correct"]
        assert abs(got["asr"] - want["asr"]) * want["clean_correct"] \
            <= 1 + 1e-6
    for key in ("knn_dist", "uniform_dist"):
        assert np.isfinite(got[key]), key
    return got, want


@pytest.mark.parametrize("extra", [
    ["--attack_type", "IFGSM", "--num_iter", "8", "--budget", "0.03"],
    ["--attack_type", "IFGSM", "--num_iter", "8", "--budget", "0.03",
     "--defense_method", "sor", "--eval_defense_method", "jitter"],
    ["--attack_type", "drop", "--num_drop", "24"]],
    ids=["ifgsm", "ifgsm-sor-jitter", "drop"])
def test_main_asr_matches_jax_main(extra):
    """`main` with ``--device cpu`` against the JAX `main` on the same
    arguments (the random starts come from different generators)."""
    got, want = _against_jax(TRAINED + extra, "jitter" in extra)
    assert 0 < want["asr"] < 1
    if "drop" in extra:
        # SaliencyDrop draws nothing, so both packages delete the same
        # points: the metrics agree up to f32 sums in other orders
        for key in ("knn_dist", "uniform_dist"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-7, err_msg=key)
        # CurvStdDist is undefined across clouds of different sizes
        assert np.isnan(got["curv_std_dist"]) and \
            np.isnan(want["curv_std_dist"])
    else:
        assert np.isfinite(got["curv_std_dist"])


def test_main_geoa3_matches_jax_main(geoa3_victim):
    """``--model geoa3_pointnet --attack_type GeoA3`` (2 x 5) on a JAX
    draw of the victim, through both packages' `main`. The eval passes
    the true labels, so the targeted GeoA3 pulls towards them, as in the
    JAX package; a random victim is right on few clouds."""
    got, _ = _against_jax([
        "--dataset", "synthetic", "--batch_size", "16", "--synthetic_size",
        "16", "--num_point", "64", "--num_class", "10", "--model",
        "geoa3_pointnet", "--checkpoint", geoa3_victim, "--attack_type",
        "GeoA3", "--binary_step", "2", "--num_iter", "5", "--curv_loss_knn",
        "8", "--log_dir", ""])
    assert np.isfinite(got["curv_std_dist"])


@pytest.fixture(scope="module")
def jax_ae(tmp_path_factory):
    """An AE for 64-point clouds drawn by the JAX package and pickled by
    its ``save_params``, for both packages' ``--ae_checkpoint``."""
    path = str(tmp_path_factory.mktemp("ae") / "ae.pkl")
    JCK.save_params(path, JAE.init(jax.random.PRNGKey(3), num_points=64))
    return path


@pytest.mark.parametrize("extra", [
    ["--attack_type", "Add", "--binary_step", "2", "--num_iter", "5"],
    ["--attack_type", "Add-Cluster", "--num_iter", "4", "--num_point",
     "128"],
    ["--attack_type", "AOF", "--num_iter", "5"],
    ["--attack_type", "UAdvPC", "--num_iter", "5"],
    ["--attack_type", "CW-LPIPS", "--binary_step", "2", "--num_iter", "5"]],
    ids=["add", "add-cluster", "aof", "uadvpc", "cw-lpips"])
def test_main_add_and_ae_attacks_match_jax_main(extra, jax_ae):
    """The Add attacks, AOF, UAdvPC (both packages on one AE that the JAX
    package saved, through ``--ae_checkpoint``) and CW-LPIPS through both
    `main`s on the trained victim: the same clean-correct clouds and ASR
    within one example. The Add attacks are targeted at the true labels,
    as in the JAX package, so a cloud flips only where they fail and
    leave it elsewhere. Add-Cluster takes 128 critical points, so its
    clouds have 128 points."""
    got, _ = _against_jax(TRAINED + extra + ["--ae_checkpoint", jax_ae])
    if "Add" in extra[1]:
        assert np.isnan(got["curv_std_dist"])
    else:
        assert np.isfinite(got["curv_std_dist"])


# the registry names of `README.md`, each of which `build_attack` builds
REGISTRY = ("HiT-ADV", "FGSM", "IFGSM", "MIFGSM", "PGD", "FGSM-RS", "FGM-L2",
            "IFGM-L2", "CW-Perturb", "CW-UPerturb", "CW-LPIPS", "CW-KNN",
            "CW-UKNN", "GeoA3", "GeoA3-Untarget", "AOF", "TAOF", "UAEAOF",
            "AdvPC", "UAdvPC", "Add", "Add-Cluster", "Add-Object", "Drop")


@pytest.mark.parametrize("name", REGISTRY)
def test_every_registry_name_builds(name):
    """Each of the 24 names builds an attack on the CPU (the AE attacks on
    a random AE, ``--ae_fit_steps 0``; CW-LPIPS on the PointNet it is
    handed)."""
    assert not hasattr(EV, "_ATTACK_ITEMS")
    cfg = CFG.EvalConfig(attack_type=name, dataset="synthetic",
                         num_point=64, ae_fit_steps=0, device="cpu")
    model = PointNet(10, device="cpu")
    assert callable(EV.build_attack(cfg, model, model))


def test_ae_cache_keeps_f32_and_bf16_fits_apart(tmp_path, monkeypatch,
                                               capsys):
    """`eval.default_ae` caches an f32 fit under the JAX package's file
    name (`hitadv_tpu/eval.py`: dataset, points, steps, seed) and a bf16
    fit under that name with ``_bf16``; a later call of either precision
    loads its own fit, never the other's."""
    import torch

    monkeypatch.setenv("HITADV_CACHE_DIR", str(tmp_path))
    base = dict(attack_type="uadvpc", dataset="synthetic", batch_size=4,
                synthetic_size=8, num_point=64, ae_fit_steps=1, seed=2,
                device="cpu")
    cfgs = (CFG.EvalConfig(**base), CFG.EvalConfig(bf16=True, **base))
    names = ("ae_synthetic_64p_1s_2.pkl", "ae_synthetic_64p_1s_2_bf16.pkl")
    assert [os.path.basename(EV.ae_cache_path(c)) for c in cfgs] == \
        list(names)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 3).astype(
        np.float32))
    with torch.no_grad():
        fitted = [EV.default_ae(c)(x) for c in cfgs]
        assert sorted(os.listdir(tmp_path)) == list(names)
        capsys.readouterr()
        cached = [EV.default_ae(c)(x) for c in cfgs]
    assert capsys.readouterr().out.count("loading cached fitted AE") == 2
    for a, b in zip(fitted, cached):
        assert torch.equal(a, b)
    assert not torch.equal(*fitted)


def test_cw_lpips_needs_the_pointnet():
    for cfg, model in ((CFG.EvalConfig(attack_type="cw-lpips",
                                       device="cpu"), None),
                       (CFG.EvalConfig(attack_type="cw-lpips", model="dgcnn",
                                       device="cpu"),
                        PointNet(10, device="cpu"))):
        with pytest.raises(ValueError, match="pointnet"):
            EV.build_attack(cfg, lambda x: x, model)


@pytest.mark.parametrize("name", [
    "FGSM", "IFGSM", "MIFGSM", "PGD", "FGSM_RS", "FGM_l2", "IFGM_l2",
    "drop", "GeoA3", "GeoA3-Untarget", "add", "add_cluster", "add_object",
    "aof", "taof", "uaeaof", "advpc", "uadvpc", "cw_lpips"])
def test_ported_settings_build(name):
    """Each registry name builds an attack with the defenses set (the
    names in their other spellings; the AE attacks on an AE they are
    handed, CW-LPIPS on the PointNet)."""
    cfg = CFG.EvalConfig(attack_type=name, dataset="synthetic",
                         model="pointnet" if name == "cw_lpips" else
                         "geoa3_pointnet", defense_method="srs",
                         eval_defense_method="sor", device="cpu")
    model = PointNet(10, device="cpu") if name == "cw_lpips" else None
    assert callable(EV.build_attack(cfg, lambda x: x, model,
                                    ae_fn=lambda x: x))
