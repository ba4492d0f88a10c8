"""The trace reduction, the roofline shares and the idle share on a
synthetic timeline."""

import types

import pytest

from bench_port import harness, tracing
from bench_port.peaks import FLOPS, HBM_BYTES_PER_S


def _events():
    k = "(anonymous namespace)::maxlin_f32_kernel(float const*)"
    ew = "void at::native::vectorized_elementwise_kernel<4, add>"
    return [
        {"cat": "kernel", "name": k, "ts": 100.0, "dur": 400.0},
        {"cat": "kernel", "name": ew, "ts": 450.0, "dur": 100.0},   # overlap
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 700.0,
         "dur": 50.0},
        {"cat": "kernel", "name": k, "ts": 1000.0, "dur": 400.0},
        {"cat": "cpu_op", "name": "aten::mul", "ts": 560.0, "dur": 60.0},
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 500.0, "dur": 500.0},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 800.0, "dur": 150.0},
        {"cat": "ac2g", "name": "flow", "ts": 1.0},
    ]


def test_reduce_events():
    t = tracing.reduce_events(_events(), 0.002, {"max_linear": []})
    # busy: [100, 550] + [700, 750] + [1000, 1400] = 900 us
    assert t.busy_s == pytest.approx(900e-6)
    assert t.seconds_of("maxlin_f32_kernel") == (pytest.approx(800e-6), 2)
    gaps = dict(t.idle_gaps)
    # gap 550-700 (middle 625: aten::copy_, inner ops end at 620), gap
    # 750-1000 (middle 875: aten::mm, the innermost)
    assert gaps == {"aten::copy_": pytest.approx(150e-6),
                    "aten::mm": pytest.approx(250e-6)}


def _run(trace, traffic=None, pre=(0.0, 0)):
    cell = harness.load_cell("pointnet.ifgsm.b256")
    if traffic:
        cell.traffic.update(traffic)
    return types.SimpleNamespace(trace=trace, cell=cell,
                                 pre_trace_attack=lambda: pre)


def test_roofline_and_idle():
    B, N, K, C = 2, 8, 4, 16
    calls = [(B, N, K, C, "torch.float32")] * 2
    t = tracing.reduce_events(_events(), 0.002, {"max_linear": calls})
    run = _run(t, {"trace_calls": [0, 2]}, pre=(0.03, 20))
    flops = 2.0 * B * N * K * C
    nbytes = (B * N * K + K * C) * 4 + C * 4 + B * C * 8
    least = max(flops / FLOPS["torch.float32"], nbytes / HBM_BYTES_PER_S)
    got = harness.metric_module("max_linear_roofline").read(run)
    assert got == pytest.approx(100.0 * 2 * least / 800e-6)
    # 900 us busy over 2 traced iterations against 1.5 ms an iteration
    # before the profiler
    idle = harness.metric_module("device_idle_share").read(run)
    assert idle == pytest.approx(100.0 * (1 - 450e-6 / 1.5e-3))
    ew = harness.metric_module("elementwise_ms_per_iter").read(run)
    assert ew == pytest.approx(0.1 / 2)


def test_roofline_silent_without_its_calls():
    t = tracing.reduce_events(_events(), 0.002, {"max_linear": [],
                                                 "knn": []})
    run = _run(t)
    assert harness.metric_module("max_linear_roofline").read(run) is None
    assert harness.metric_module("knn_roofline").read(run) is None


def test_knn_roofline():
    ev = [{"cat": "kernel", "name": "void knn_feat_kernel<float>",
           "ts": 0.0, "dur": 1000.0}]
    calls = [(2, 16, 8, 16, 20, "torch.float32")]
    t = tracing.reduce_events(ev, 0.001, {"knn": calls})
    run = _run(t)
    flops = (2.0 * 8 + 3) * 2 * 16 * 16
    nbytes = (2 * 16 * 8 * 2) * 4 + 2 * 16 * 20 * 8
    least = max(flops / FLOPS["torch.float32"], nbytes / HBM_BYTES_PER_S)
    assert harness.metric_module("knn_roofline").read(run) == \
        pytest.approx(100.0 * least / 1e-3)


@pytest.mark.parametrize("cell, before, after", [
    # traced batch 1 from its first call: batch 0 before, 2 and 3 after
    ("pointnet.ifgsm.b256", (1.5 + 0.01, 100), (1.6 + 1.7, 200)),
    # traced batch 0 from call 901: the preparation and 900 iterations
    ("pointnet.hitadv.b256", (0.01, 900), (2.0 + 1.6 + 1.7, 3000)),
])
def test_spans_before_and_after_the_profiler(cell, before, after):
    c = harness.load_cell(cell)
    batches = [harness.BatchRecord(i, None, None, attack_s=a)
               for i, a in enumerate((1.5, 2.0, 1.6, 1.7))]
    batches[c.traffic["trace_batch"]].pre_trace_s = 0.01
    run = harness.Run(cell=c, seed=0, setup_s=0.0, setup_parts={},
                      window_s=1.0, examples=0, batches=batches,
                      eval_metrics={}, memory_peak_bytes=0)
    assert run.pre_trace_attack() == (pytest.approx(before[0]), before[1])
    assert run.post_trace_attack() == (pytest.approx(after[0]), after[1])
    s, n = before
    assert harness.metric_module("attack_ms_per_iter").read(run) == \
        pytest.approx(1e3 * s / n)


def test_no_trace_no_host_metrics():
    c = harness.load_cell("pointnet.hitadv.b256")
    run = harness.Run(cell=c, seed=0, setup_s=0.0, setup_parts={},
                      window_s=1.0, examples=0,
                      batches=[harness.BatchRecord(0, None, None,
                                                   attack_s=1.0)],
                      eval_metrics={}, memory_peak_bytes=0)
    assert run.pre_trace_attack() == (0.0, 0)
    for name in ("attack_ms_per_iter", "mfu", "device_idle_share"):
        assert harness.metric_module(name).read(run) is None


@pytest.mark.parametrize("traced", [39, 40, 41, 30])
def test_roofline_with_launches_lost_or_gained(traced):
    """40 calls of one shape: a trace one launch short or over reads the
    same share; one a quarter short reads nothing."""
    ev = [{"cat": "kernel", "name": "maxlin_f32_kernel", "ts": 100.0 * i,
           "dur": 50.0} for i in range(traced)]
    calls = [(2, 8, 4, 16, "torch.float32")] * 40
    t = tracing.reduce_events(ev, 0.01, {"max_linear": calls})
    got = harness.metric_module("max_linear_roofline").read(_run(t))
    if traced == 30:
        assert got is None
        return
    flops = 2.0 * 2 * 8 * 4 * 16
    nbytes = (2 * 8 * 4 + 4 * 16) * 4 + 16 * 4 + 2 * 16 * 8
    least = max(flops / FLOPS["torch.float32"], nbytes / HBM_BYTES_PER_S)
    assert got == pytest.approx(100.0 * least / 50e-6)
