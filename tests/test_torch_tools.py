"""The port's remaining drivers and utilities against the JAX package's:
`hitadv_torch.convert` (its CLI), `hitadv_torch.visual` and
`hitadv_torch.utils` (`logging`, `training_aux`, `mesh_io`), file for
file where they write files. The port runs on the CPU (``--device
cpu``), where its kernels take their plain versions. `utils.profiling`,
the port's span recorder, is tested in `test_torch_spans.py`.
"""

import filecmp
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hitadv_tpu import convert as JCV
from hitadv_tpu import visual as JV
from hitadv_tpu.data import synthetic_clouds
from hitadv_tpu.models import geoa3_pointnet as JG3
from hitadv_tpu.models import pointnet as JPN
from hitadv_tpu.ops import geometry as JG
from hitadv_tpu.utils import logging as JL
from hitadv_tpu.utils import mesh_io as JM
from hitadv_tpu.utils import training_aux as JA
from hitadv_torch import convert as CV
from hitadv_torch import visual as V
from hitadv_torch.attacks import aof as O
from hitadv_torch.ops import geometry as G
from hitadv_torch.utils import logging as TL
from hitadv_torch.utils import mesh_io as TM
from hitadv_torch.utils import training_aux as TA
from test_torch_kernels import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def jax_backend():
    backend = JG.get_backend()
    JG.set_backend("xla")
    try:
        yield
    finally:
        JG.set_backend(backend)


# ---------------------------------------------------------------------------
# utils.logging
# ---------------------------------------------------------------------------

def test_topk_accuracy_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(32, 10).astype(np.float32)
    targets = rng.randint(0, 10, 32)
    want = JL.topk_accuracy(logits, targets, topk=(1, 3, 5))
    assert TL.topk_accuracy(logits, targets, topk=(1, 3, 5)) == want
    assert TL.topk_accuracy(torch.from_numpy(logits),
                            torch.from_numpy(targets), (1, 3, 5)) == want


def test_avg_meter_matches_jax():
    a, b = JL.AvgMeter("x"), TL.AvgMeter("x")
    for v, c in ((1.5, 2), (float("nan"), 1), (-3.0, 4), (0.25, 1)):
        a.update(v, c)
        b.update(v, c)
        assert (b.now, b.num, b.sum, b.mean) == (a.now, a.num, a.sum, a.mean)
    assert b.now == 0.25 and a.sum == b.sum and b.name == "x"
    b.reset()
    assert (b.sum, b.mean, b.num, b.now) == (0.0, 0.0, 0, 0.0)


# ---------------------------------------------------------------------------
# utils.training_aux
# ---------------------------------------------------------------------------

def test_training_aux_writes_what_jax_writes(tmp_path):
    state = {"epoch": 3, "w": np.arange(6, dtype=np.float32)}
    dirs = {}
    for name, mod in (("jax", JA), ("port", TA)):
        d = str(tmp_path / name)
        aux = mod.TrainingAux(d)
        assert aux.load_checkpoint() is None
        aux.save_checkpoint(state, is_best=False)
        aux.save_checkpoint({**state, "epoch": 4}, is_best=True)
        aux.write_err_to_file("epoch 3: 0.5\n")
        aux.write_err_to_file("epoch 4: 0.25\n")
        got = aux.load_checkpoint(is_best=True)
        assert got["epoch"] == 4 and np.array_equal(got["w"], state["w"])
        dirs[name] = d
    for f in ("checkpoint.pkl", "modelBest.pkl", "state.txt"):
        assert filecmp.cmp(os.path.join(dirs["jax"], f),
                           os.path.join(dirs["port"], f), shallow=False), f


def test_recorders_write_what_jax_writes(tmp_path):
    for name, mod in (("jax", JA), ("port", TA)):
        d = str(tmp_path / name)
        conv, loss = mod.ConvergenceRecorder(d), mod.LossRecorder(d)
        for s in (3, 17, 17, 99):
            conv.record(s)
        for v in (2.5, np.float32(1.25), 0.5):
            loss.record(v)
        conv.save()
        loss.save()
    for f in ("converge_iter.json", "loss_iter.json"):
        assert filecmp.cmp(str(tmp_path / "jax" / f),
                           str(tmp_path / "port" / f), shallow=False), f
    with open(tmp_path / "port" / "loss_iter.json") as fh:
        assert json.load(fh) == [2.5, 1.25, 0.5]
    for f in ("converge_iter.png", "loss_iter.png"):
        assert (tmp_path / "port" / f).exists() \
            == (tmp_path / "jax" / f).exists()


# ---------------------------------------------------------------------------
# utils.mesh_io
# ---------------------------------------------------------------------------

def test_mesh_files_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    v = rng.randn(7, 3).astype(np.float32)
    f = rng.randint(0, 7, (5, 3))
    for name, mod in (("jax", JM), ("port", TM)):
        d = tmp_path / name
        d.mkdir()
        mod.write_obj(str(d / "m.obj"), v, f)
        mod.write_off(str(d / "m.off"), v, f)
        mod.write_asc(str(d / "m.asc"), v)
        assert mod.reconstruct_from_pc(7, str(d / "rec"), "adv", v) is None
    for fname in ("m.obj", "m.off", "m.asc", "rec/adv.obj"):
        assert filecmp.cmp(str(tmp_path / "jax" / fname),
                           str(tmp_path / "port" / fname), shallow=False)
    p = tmp_path / "port"
    for a, b in ((TM.read_obj(str(p / "m.obj")), JM.read_obj(str(p / "m.obj"))),
                 (TM.read_off(str(p / "m.off")), JM.read_off(str(p / "m.off")))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(TM.read_asc(str(p / "m.asc")),
                                  JM.read_asc(str(p / "m.asc")))
    # ModelNet's OFF files glue the counts to the magic word
    glued = tmp_path / "glued.off"
    glued.write_text("OFF3 1 0\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    for x, y in zip(TM.read_off(str(glued)), JM.read_off(str(glued))):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# convert (the CLI)
# ---------------------------------------------------------------------------

def _state_dict(tree, spec):
    """The reference's torch state dict that ``spec`` maps to ``tree``."""
    sd = {}
    for path, (prefix, kind) in spec.items():
        node = tree
        for part in path.split("/"):
            node = node[part]
        if kind == "bn":
            for k, t in (("scale", "weight"), ("bias", "bias"),
                         ("mean", "running_mean"), ("var", "running_var")):
                sd[f"{prefix}.{t}"] = torch.from_numpy(np.array(node[k]))
            continue
        w = np.array(node["w"])
        if kind == "conv":
            w = w.T[..., None]                    # [Cout, Cin, 1]
        elif kind == "linear":
            w = w.T
        else:
            w = w.transpose(2, 1, 0)              # [Cout, Cin, K]
        sd[f"{prefix}.weight"] = torch.from_numpy(w.copy())
        if "b" in node:
            sd[f"{prefix}.bias"] = torch.from_numpy(np.array(node["b"]))
    return sd


@pytest.mark.parametrize("name,mod", [("pointnet", JPN),
                                      ("geoa3_pointnet", JG3)])
def test_convert_cli_gives_the_jax_tree(tmp_path, capsys, name, mod):
    """Both CLIs convert the same torch checkpoint (the reference's
    ``model_state_dict`` wrapper) into the same tree, bit for bit."""
    tree = jax.tree_util.tree_map(np.asarray, mod.init(
        jax.random.PRNGKey(4), num_classes=10))
    src = str(tmp_path / "victim.checkpoint")
    torch.save({"model_state_dict": _state_dict(tree, mod.TORCH_SPEC)}, src)
    jdst, tdst = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    JCV.main(["--model", name, "--src", src, "--dst", jdst])
    got = CV.main(["--model", name, "--src", src, "--dst", tdst,
                   "--device", "cpu"])
    assert "logits (2, 10) finite" in capsys.readouterr().out
    from hitadv_torch.utils.checkpoint import load_params

    for ours in (got, load_params(tdst)):
        flat_a = jax.tree_util.tree_leaves_with_path(load_params(jdst))
        flat_b = jax.tree_util.tree_leaves_with_path(ours)
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (_, a), (_, b) in zip(flat_a, flat_b):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_convert_cli_refuses_orbax(tmp_path, capsys):
    with pytest.raises(SystemExit):
        CV.main(["--model", "pointnet", "--src", "x", "--dst", "y",
                 "--orbax", "--device", "cpu"])
    assert "JAX machinery" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# visual
# ---------------------------------------------------------------------------

VISUAL_N, LOW_PASS = 256, 20


def test_visual_spectral_matches_jax(tmp_path):
    """``--mode spectral`` on one synthetic cloud: the low-frequency part
    against JAX's `spectral_decompose`, after asserting that the kNN
    graph agrees and the eigengap at the cut is wide (1000 eps32
    lambda_max); the parts may differ by the projector's Davis-Kahan
    bound, 100 eps32 lambda_max / gap, times the cloud's norm."""
    lfc = V.main(["--device", "cpu", "--mode", "spectral", "--num_point",
                  str(VISUAL_N), "--low_pass", str(LOW_PASS), "--out_dir",
                  str(tmp_path)])
    xyz = synthetic_clouds(1, VISUAL_N, seed=0)[0][0, :, :3]
    pc = torch.from_numpy(xyz.copy())[None]
    np.testing.assert_array_equal(
        G.knn_idx(pc, pc, 30).numpy(),
        np.asarray(JG.knn_points(jnp.asarray(xyz)[None],
                                 jnp.asarray(xyz)[None], 30).idx))
    e = O.graph_laplacian(pc, 30)[0][0].numpy()
    eps = np.finfo(np.float32).eps
    gap, lam = e[LOW_PASS] - e[LOW_PASS - 1], e[-1]
    assert gap > 1000 * eps * lam, (gap, lam)
    jlfc, jhfc = JV.spectral_decompose(xyz, low_pass=LOW_PASS)
    bound = 100 * eps * lam / gap * np.linalg.norm(xyz)
    assert np.abs(lfc - jlfc).max() <= bound, (np.abs(lfc - jlfc).max(),
                                               bound)
    hfc = np.loadtxt(next(tmp_path.glob("hfc_*.asc")))
    assert np.abs(hfc - jhfc).max() <= bound + 1e-6      # the dump's 6 digits
    assert np.abs(lfc + hfc - xyz).max() <= 1e-5
    assert len(list(tmp_path.glob("spectral_*.html"))) == 1


def test_visual_attack_mode(tmp_path, capsys):
    """``--mode attack``: HiT-ADV cut to 1 x 3 against a fresh PointNet on
    one synthetic cloud, its dumps written; the adversarial cloud finite
    and within the budget."""
    adv = V.main(["--device", "cpu", "--num_point", str(VISUAL_N),
                  "--binary_step", "1", "--num_iter", "3", "--central_num",
                  "16", "--total_central_num", "32", "--out_dir",
                  str(tmp_path)])
    xyz = synthetic_clouds(1, VISUAL_N, seed=0)[0][0, :, :3]
    assert adv.shape == (VISUAL_N, 3) and np.isfinite(adv).all()
    assert np.abs(adv - xyz).max() <= 0.55 + 1e-4
    out = capsys.readouterr().out
    assert "clean pred" in out and "success" in out
    saved = np.loadtxt(next(tmp_path.glob("adv_*.asc")))
    np.testing.assert_allclose(saved, adv, atol=1e-6)
    assert len(list(tmp_path.glob("adv_*.html"))) == 1
