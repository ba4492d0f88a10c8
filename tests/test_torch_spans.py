"""The port's spans and counters (`hitadv_torch.utils.profiling`) and the
spans of `evaluation.eval_asr`, HiT-ADV and the FGM family.

The CPU tests hold the recorder off and on, its clock against a
`torch.profiler` Chrome trace, the spans and counters of a tiny eval and
``python -m hitadv_torch.eval --spans``. The tests marked ``cuda`` need
a card: spans add no host-device synchronisation inside the attack, and
every span has device times, on the host clock, once `eval_asr` returns.
The file imports neither JAX nor the JAX package, so on a machine with
only PyTorch run

    python -m pytest tests/test_torch_spans.py -m cuda --noconftest
"""

import json
import statistics

import pytest
import torch

from hitadv_torch import eval as EV
from hitadv_torch import evaluation as E
from hitadv_torch.attacks import (FGMConfig, HiTADVConfig, make_adv_fn,
                                  make_hit_adv, make_ifgsm)
from hitadv_torch.data import synthetic_batches
from hitadv_torch.models import PointNet
from hitadv_torch.ops import kernels as K
from hitadv_torch.utils import profiling as P

EVAL_SPANS = ("eval.batch", "eval.copy", "eval.attack", "eval.metrics",
              "eval.judge", "eval.read")


@pytest.fixture(autouse=True)
def fresh_spans():
    """Spans off and empty around every test, on one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    P.disable()
    P.reset()
    try:
        yield
    finally:
        P.disable()
        P.reset()
        torch.set_num_threads(threads)


def _attacks(dev):
    """A tiny HiT-ADV (2 binary steps x 3 iterations) and IFGSM (3 steps)
    against a random PointNet: ``{name: (victim, attack, iterations a
    batch)}``."""
    torch.manual_seed(0)
    model = PointNet(10, device=dev)
    adv_fn = make_adv_fn("logits", 30.0)
    hit = make_hit_adv(model, adv_fn, HiTADVConfig(
        binary_step=2, num_iter=3, central_num=8, total_central_num=16,
        curv_loss_knn=8), device=dev)
    ifgsm = make_ifgsm(model, adv_fn, FGMConfig(budget=0.05, num_iter=3),
                       device=dev)
    return model, {"hitadv": (hit, 6), "ifgsm": (ifgsm, 3)}


def _batches():
    return synthetic_batches(2, 4, num_points=128, num_classes=10, seed=5)


def _by_batch(records):
    out = {}
    for r in records:
        out.setdefault(r["batch"], []).append(r)
    return out


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

def test_spans_off_touch_nothing(monkeypatch):
    """Off: one shared no-op context, no CUDA event, no profiler range,
    no record, no counter."""
    def refuse(*a, **k):
        raise AssertionError("touched while spans are off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not P.enabled()
    first = P.span("eval.batch", batch=0)
    assert P.span("attack.iteration") is first
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with first:
            with P.span("attack.iteration"):
                P.count("attack.iterations")
    P.resolve()
    P.collect()
    assert P.records() == []
    assert not [k for k in P.counters() if not k.startswith("kernels.")]


def test_spans_nest_and_count():
    """On: each span's parent is the one open around it, its batch the
    nearest given, host times in order; counters add up; without a card
    the device fields stay None."""
    P.enable("cpu")
    with P.span("outer"):
        with P.span("eval.batch", batch=7):
            with P.span("eval.attack"):
                for _ in range(3):
                    with P.span("attack.iteration"):
                        P.count("attack.iterations")
            P.count("eval.examples", 4)
            P.count("eval.examples", 4)
        with P.span("after"):
            pass
    P.collect()
    recs = P.records()
    assert [r["name"] for r in recs] == [
        "outer", "eval.batch", "eval.attack"] + ["attack.iteration"] * 3 + [
        "after"]
    assert [r["parent"] for r in recs] == [None, 0, 1, 2, 2, 2, 0]
    assert [r["batch"] for r in recs] == [None] + [7] * 5 + [None]
    for r in recs:
        assert r["host_start_ns"] <= r["host_end_ns"]
        assert r["device_start_ns"] is None and r["device_end_ns"] is None
    it = recs[3:6]
    for a, b in zip(it, it[1:]):
        assert a["host_end_ns"] <= b["host_start_ns"]
    assert recs[0]["host_start_ns"] <= recs[1]["host_start_ns"]
    assert recs[1]["host_end_ns"] <= recs[6]["host_start_ns"]
    assert recs[6]["host_end_ns"] <= recs[0]["host_end_ns"]
    c = P.counters()
    assert c["attack.iterations"] == 3 and c["eval.examples"] == 8
    P.disable()
    with P.span("ignored"):
        P.count("attack.iterations")
    assert len(P.records()) == 7 and P.counters()["attack.iterations"] == 3
    P.reset()
    assert P.records() == [] and "attack.iterations" not in P.counters()


def test_counters_read_kernel_launches():
    """`counters` reads `kernels.LAUNCHES` itself, as it stands, and
    `reset` clears it with the spans' counters."""
    assert set(P.counters()) >= {f"kernels.launches.{k}" for k in K.LAUNCHES}
    K.LAUNCHES["knn"] += 5
    assert P.counters()["kernels.launches.knn"] == 5
    K.LAUNCHES["knn"] += 2
    assert P.counters()["kernels.launches.knn"] == 7
    P.reset()
    assert K.LAUNCHES["knn"] == 0 == P.counters()["kernels.launches.knn"]


def test_summary_from_host_times(monkeypatch):
    """`summary`: count, total and median ms by span name, device ms None
    without a card, and the counters."""
    ticks = iter(range(0, 10 ** 9, 10 ** 6))       # each read 1 ms later
    monkeypatch.setattr(P.time, "perf_counter_ns", lambda: next(ticks))
    P.enable("cpu")
    with P.span("a"):                  # 0 .. 7 ms
        for _ in range(3):
            with P.span("b"):          # 1 ms each
                pass
    P.count("eval.batches")
    s = P.summary()
    assert s["spans"]["a"] == {"count": 1, "host_ms_total": 7.0,
                               "host_ms_median": 7.0,
                               "device_ms_total": None,
                               "device_ms_median": None}
    assert s["spans"]["b"]["count"] == 3
    assert s["spans"]["b"]["host_ms_total"] == 3.0
    assert s["spans"]["b"]["host_ms_median"] == 1.0
    assert s["counters"]["eval.batches"] == 1
    json.dumps(s)


def test_enable_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.enable("cuda")
    assert not P.enabled()


def test_span_start_on_the_trace_clock(tmp_path):
    """While a profiler records, a span appears in its Chrome trace as a
    ``user_annotation``, and its start put on the trace's clock
    (`to_trace_ns`) lies within 2 ms of the trace's (``ts`` * 1e3 +
    ``baseTimeNanoseconds``); outside the profiler none is entered."""
    P.enable("cpu")
    with P.span("before_profiler"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with P.span("attack.iteration"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    marks = sorted(float(e["ts"]) * 1e3 + base
                   for e in trace["traceEvents"]
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == "attack.iteration")
    spans = [P.to_trace_ns(r["host_start_ns"]) for r in P.records()
             if r["name"] == "attack.iteration"]
    assert len(marks) == len(spans) == 3
    for mark, start in zip(marks, spans):
        assert abs(mark - start) < 2e6
    assert not any(e.get("name") == "before_profiler"
                   for e in trace["traceEvents"])


# ---------------------------------------------------------------------------
# The evaluation's spans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["hitadv", "ifgsm"])
def test_eval_asr_spans(name):
    """A tiny eval, spans on: per batch one of each eval span under
    ``eval.batch``, as many ``attack.iteration`` spans as the attack
    takes steps, counted by ``attack.iterations``; the metrics bitwise
    those of the same eval with spans off."""
    model, attacks = _attacks("cpu")
    attack, iters = attacks[name]
    kw = dict(seed=11, uniform_k=3, verbose=False, device="cpu")
    want = E.eval_asr(model, attack, _batches(), **kw)
    P.enable("cpu")
    got = E.eval_asr(model, attack, _batches(), **kw)
    P.disable()
    assert got == want
    recs = P.records()
    batches = _by_batch(recs)
    assert sorted(batches) == [0, 1]
    for b, rs in batches.items():
        names = [r["name"] for r in rs]
        for span in EVAL_SPANS:
            assert names.count(span) == 1, (b, span)
        assert names.count("attack.iteration") == iters
        assert names.count("attack.prepare") == 1
        assert names.count("attack.finalize") == 1
        top = recs.index(rs[0])
        assert rs[0]["name"] == "eval.batch" and rs[0]["parent"] is None
        attack_span = next(recs.index(r) for r in rs
                           if r["name"] == "eval.attack")
        for r in rs[1:]:
            assert r["parent"] is not None and r["parent"] >= top
        for r in rs:
            if r["name"] == "attack.iteration":
                parent = recs[r["parent"]]["name"]
                assert parent == ("attack.binary_step" if name == "hitadv"
                                  else "eval.attack")
            if r["name"] in ("eval.copy", "eval.attack", "eval.read"):
                assert r["parent"] == top
            if r["name"] in ("attack.prepare", "attack.finalize"):
                assert recs[r["parent"]]["name"] in ("eval.attack",
                                                     "attack.binary_step")
                assert r["parent"] >= attack_span
        if name == "hitadv":
            assert names.count("attack.binary_step") == 2
    c = P.counters()
    assert c["attack.iterations"] == 2 * iters
    assert c["eval.batches"] == 2 and c["eval.examples"] == 8
    assert c.get("attack.binary_steps", 0) == (4 if name == "hitadv" else 0)


def test_eval_main_writes_spans(tmp_path):
    """``python -m hitadv_torch.eval --spans PATH`` writes the summary of
    the run's spans and counters, and leaves spans off."""
    path = tmp_path / "spans.json"
    m = EV.main(["--dataset", "synthetic", "--batch_size", "2",
                 "--synthetic_size", "4", "--num_point", "128",
                 "--binary_step", "2", "--num_iter", "2", "--central_num",
                 "8", "--total_central_num", "16", "--curv_loss_knn", "8",
                 "--device", "cpu", "--log_dir", "", "--spans", str(path)])
    assert m["total"] == 4
    assert not P.enabled()
    out = json.loads(path.read_text())
    spans, counters = out["spans"], out["counters"]
    for name in EVAL_SPANS:
        assert spans[name]["count"] == 2, name
    assert spans["attack.iteration"]["count"] == 8
    assert spans["attack.binary_step"]["count"] == 4
    for s in spans.values():
        assert set(s) == {"count", "host_ms_total", "host_ms_median",
                          "device_ms_total", "device_ms_median"}
        assert s["host_ms_total"] >= s["host_ms_median"] > 0
        assert s["device_ms_total"] is None and s["device_ms_median"] is None
    assert counters["eval.batches"] == 2 and counters["eval.examples"] == 4
    assert counters["attack.iterations"] == 8
    assert counters["attack.binary_steps"] == 4
    assert "kernels.launches.max_linear" in counters


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_add_no_sync_inside_the_attack(cuda):
    """The flagship's attack (HiT-ADV against PointNet, f32, 1024 points,
    Cn 192 of 256) at B = 16, 2 binary steps x 10 iterations, under
    ``set_sync_debug_mode("error")``: it runs with spans off and on, and
    the spans it recorded resolve only afterwards."""
    from hitadv_torch.data import synthetic_clouds

    torch.manual_seed(0)
    model = PointNet(40, device=cuda)
    attack = make_hit_adv(model, make_adv_fn("logits", 30.0), HiTADVConfig(
        binary_step=2, num_iter=10), device=cuda)
    pts, labels = synthetic_clouds(16, 1024, seed=3)
    pts = torch.from_numpy(pts).to(cuda)
    labels = torch.from_numpy(labels).to(cuda).long()
    results = []
    for on in (False, True):
        if on:
            P.enable(cuda)
        gen = torch.Generator(device=cuda).manual_seed(4)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            results.append(attack(pts, labels, gen))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        P.disable()
    recs = P.records()
    assert len([r for r in recs if r["name"] == "attack.iteration"]) == 20
    assert all(r["device_start_ns"] is None for r in recs)
    P.collect()
    assert all(r["device_start_ns"] is not None for r in P.records())
    assert torch.equal(results[0].adv_points, results[1].adv_points)


@pytest.mark.cuda
def test_eval_asr_spans_on_the_card(cuda):
    """After `eval_asr` returns, every span has device start and end,
    with no `collect`; each starts on the device at or after its host
    start and ends after it starts; the iterations lie inside the attack
    on the device clock."""
    model, attacks = _attacks(cuda)
    attack, iters = attacks["hitadv"]
    P.enable(cuda)
    E.eval_asr(model, attack, _batches(), seed=11, uniform_k=3,
               verbose=False, device=cuda)
    P.disable()
    recs = P.records()
    assert len(recs) == 2 * (len(EVAL_SPANS) + 2 + 2 + iters)
    for r in recs:
        assert r["device_start_ns"] is not None, r
        assert r["device_start_ns"] >= r["host_start_ns"], r
        assert r["device_end_ns"] >= r["device_start_ns"], r
    for rs in _by_batch(recs).values():
        att = next(r for r in rs if r["name"] == "eval.attack")
        its = [r for r in rs if r["name"] == "attack.iteration"]
        assert all(att["device_start_ns"] <= r["device_start_ns"]
                   and r["device_end_ns"] <= att["device_end_ns"]
                   for r in its)
        assert statistics.median(r["device_end_ns"] - r["device_start_ns"]
                                 for r in its) > 0
