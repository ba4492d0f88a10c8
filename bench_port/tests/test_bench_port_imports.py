"""Nothing the benchmark's command imports is JAX or the JAX package
(top-level names compared whole); the reference imports nothing of the
port; without a card the command measures nothing and fails."""

import ast
import os
import shutil
import subprocess
import sys

from bench_port import harness

ROOT = harness.ROOT


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_port():
    for path in (harness.HERE / "reference").glob("*.py"):
        roots = set(_imported_roots(path))
        assert not roots & {"hitadv_torch", "hitadv_tpu", "jax", "jaxlib",
                            "flax"}, (path, roots)


def test_loaded_modules_have_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from bench_port import harness, checks, tracing, calibrate, run\n"
        "import torch\n"
        "c = harness.load_cell('pointnet.hitadv.b256')\n"
        "for m in c.end_to_end + c.per_layer:\n"
        "    harness.metric_module(m['name'])\n"
        "for k in ('hitadv', 'ifgsm'):\n"
        "    harness.step_module(k)\n"
        "for f in ('pointnet', 'dgcnn'):\n"
        "    harness.load_module(harness.HERE / 'reference' / (f + '.py'))\n"
        "import hitadv_torch.eval, hitadv_torch.evaluation\n"
        "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("hitadv_torch_fake_probe", sys)
    try:
        assert "hitadv_torch_fake_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["hitadv_torch_fake_probe"]


def _command(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "pointnet.ifgsm.b256", "--seed", "3", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_no_card_no_result():
    out = _command(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_jax_loaded_while_the_result_is_made_no_result(monkeypatch, capsys):
    """A module loaded while the result line is made (a metric's reader,
    say) is caught before the line is printed."""
    import types

    from bench_port import run

    def result_line(out, trace):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"correct": True}, []

    monkeypatch.setattr(run, "cards_missing", lambda chips: None)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {})
    monkeypatch.setattr(run, "result_line", result_line)
    assert run.main(["--workload", "pointnet.ifgsm.b256", "--seed", "3",
                     "--seconds", "1", "--trace", "0"]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "jax" in out.err
