"""The attacks and settings that `hitadv_torch.eval` gained with the FGM
family, SaliencyDrop, the defenses and GeoA3, against the JAX package's
`main` on the CPU, and the registry's bookkeeping."""

import os

import numpy as np
import jax
import pytest

from hitadv_tpu.models import geoa3_pointnet as JPN
from hitadv_tpu.ops import geometry as JG
from hitadv_tpu.utils import checkpoint as JCK
from hitadv_torch import config as CFG
from hitadv_torch import eval as EV
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


def test_attack_items_hold_only_items_7_and_8():
    assert set(EV._ATTACK_ITEMS) == {
        "add", "add-cluster", "add-object", "cw-lpips", "aof", "taof",
        "uaeaof", "advpc", "uadvpc"}
    assert set(EV._ATTACK_ITEMS.values()) == {
        "Add attacks", "Autoencoder attacks and CW-LPIPS"}
    for name in EV._ATTACK_ITEMS:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            EV.build_attack(CFG.EvalConfig(attack_type=name, device="cpu"),
                            None)


@pytest.mark.parametrize("name", [
    "FGSM", "IFGSM", "MIFGSM", "PGD", "FGSM_RS", "FGM_l2", "IFGM_l2",
    "drop", "GeoA3", "GeoA3-Untarget"])
def test_ported_settings_build(name):
    """`check_ported` raises for none of the ported settings, and each new
    registry name builds an attack."""
    cfg = CFG.EvalConfig(attack_type=name, dataset="synthetic",
                         model="geoa3_pointnet", defense_method="srs",
                         eval_defense_method="sor", device="cpu")
    EV.check_ported(cfg)
    assert callable(EV.build_attack(cfg, lambda x: x))
