"""Every cell, configuration, traffic mix, metric and step check of
BENCHMARK.json is a file the harness finds by its name."""

import json
import re

import pytest

from bench_port import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files(cell):
    c = harness.load_cell(cell)
    assert c.config["family"] == c.entry["config"] or c.config["family"]
    harness.step_module(c.traffic["step_check"])
    assert set(c.limits) == {"judge_gap", "step_gap", "exact_off"}
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.metric_module(m["name"]).read)
    tree = c.config_mod.tree(c.config)
    assert tree and c.config_mod.forward_flops(c.config, 8) > 0


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert NAME.match(metric["name"])
    assert (harness.HERE / "metrics" / f"{metric['name']}.py").exists()
    if "moves" in metric:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for w in metric.get("workloads", ()):
        assert w in {c["name"] for c in BENCH["workloads"]}


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench_port/")
        assert json.loads((harness.ROOT / c["file"]).read_text())[
            "source"] == c["source"]
    assert len({w["name"] for w in BENCH["workloads"]}) == len(
        BENCH["workloads"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
