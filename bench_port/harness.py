"""One run of one cell: set-up, the measured window through
`hitadv_torch.evaluation.eval_asr`, the optional trace, the comparison
with the plain reference, and the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, ``configs/<config>.json`` with its module
``configs/<config>.py`` (parameter tree, the port's victim, FLOP counts),
and a traffic mix, ``traffic/<traffic>.json`` (batch, points, the
attack's `EvalConfig` fields, the step check, the traced range). Each metric is read by
``metrics/<metric>.py``, each step check is ``steps/<kind>.py``, and the
limits of a cell's comparison are ``limits/<cell>.json``. A later cell,
traffic mix, configuration or metric is a file of its own.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that must not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "hitadv_tpu")


def load_module(path: Path) -> ModuleType:
    """The module at ``path``, loaded under a name of its own."""
    name = "bench_port._loaded." + path.relative_to(HERE).as_posix() \
        .replace("/", "_").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell with everything its files say."""
    name: str
    entry: dict              # its BENCHMARK.json entry
    config: dict             # configs/<config>.json
    config_mod: ModuleType   # configs/<config>.py
    traffic: dict            # traffic/<traffic>.json
    limits: dict             # limits/<cell>.json, {} while none is set
    end_to_end: List[dict]   # the end-to-end metrics the cell reports
    per_layer: List[dict]    # the per-layer metrics the cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``."""
    bench = read_json(ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    cfg_name = entry["config"]
    limits_path = HERE / "limits" / f"{name}.json"
    return Cell(
        name=name, entry=entry,
        config=read_json(HERE / "configs" / f"{cfg_name}.json"),
        config_mod=load_module(HERE / "configs" / f"{cfg_name}.py"),
        traffic=read_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=read_json(limits_path) if limits_path.exists() else {},
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def step_module(kind: str) -> ModuleType:
    return load_module(HERE / "steps" / f"{kind}.py")


def metric_module(name: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{name}.py")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# Set-up
# ---------------------------------------------------------------------------

def _class_shapes(classes: int):
    """Each class's ellipsoid axes, lobe count and lobe depth, from the
    class index alone (the layout of `hitadv_torch.data.synthetic`)."""
    axes = np.stack([0.4 + np.random.RandomState(1000 + c).rand(3)
                     for c in range(classes)]).astype(np.float32)
    freq = np.array([1 + c % 5 for c in range(classes)], np.float32)
    amp = np.array([0.1 + 0.1 * ((c // 5) % 4) / 3.0
                    for c in range(classes)], np.float32)
    return axes, freq, amp


def make_clouds(num: int, points: int, classes: int,
                generator: torch.Generator, device):
    """``(clouds [num, points, 6], labels [num])`` on the device: each a
    class's lobed ellipsoid sampled in random directions, centred,
    scaled into the unit sphere, with outward normals (ModelNet40's
    layout)."""
    axes, freq, amp = (torch.from_numpy(a).to(device)
                       for a in _class_shapes(classes))
    labels = torch.randint(0, classes, (num,), generator=generator,
                           device=device)
    v = torch.randn(num, points, 3, generator=generator, device=device)
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-9)
    r = 1.0 + amp[labels][:, None] * torch.cos(
        freq[labels][:, None] * torch.atan2(v[..., 1], v[..., 0]))
    pts = v * r[..., None] * axes[labels][:, None, :]
    pts = pts - pts.mean(dim=1, keepdim=True)
    pts = pts / (torch.linalg.vector_norm(pts, dim=-1).amax(
        dim=1)[:, None, None] + 1e-9)
    normals = pts / (torch.linalg.vector_norm(pts, dim=-1, keepdim=True)
                     + 1e-9)
    return torch.cat([pts, normals], dim=-1).contiguous(), labels


def eval_config(traffic: dict, device, overrides: Optional[dict] = None):
    """The `EvalConfig` of the traffic's attack, float32 on ``device``."""
    from hitadv_torch.config import EvalConfig

    fields = dict(traffic["attack"])
    fields.update(overrides or {})
    return EvalConfig(batch_size=traffic["batch"],
                      num_point=traffic["points"],
                      num_class=traffic["classes"], bf16=False,
                      k=traffic["uniform_k"], device=str(device), **fields)


# ---------------------------------------------------------------------------
# The window's records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchRecord:
    index: int
    points: torch.Tensor
    labels: torch.Tensor
    result: object = None          # the attack's AttackResult
    judged: list = dataclasses.field(default_factory=list)  # judge logits
    step: dict = dataclasses.field(default_factory=dict)    # step capture
    attack_s: Optional[float] = None
    batch_s: Optional[float] = None
    t_begin: float = 0.0           # host clock at the attack's start
    pre_trace_s: Optional[float] = None   # attack's start to the profiler's


class Recorder:
    """What the window's callables see, kept by reference (no copy, no
    wait): each batch's inputs, the attack's result, the judge's logits,
    the step module's capture, and, in a traced run, the host-clock spans
    and the traced range of attack calls."""

    def __init__(self, seed: int, traffic: dict, step_mod: ModuleType):
        self.seed, self.traffic, self.step_mod = seed, traffic, step_mod
        self.tracer = None          # set once the warm-up has run
        self.batches: List[BatchRecord] = []
        self.calls = 0
        self.capturing = False

    @property
    def current(self) -> BatchRecord:
        return self.batches[-1]

    def begin(self, points, labels) -> BatchRecord:
        """A new batch, the window's ``len(batches)``-th, as eval_asr
        numbers it."""
        index = len(self.batches)
        rec = BatchRecord(index, points, labels)
        rng = np.random.default_rng([self.seed, index, 7])
        rec.step = self.step_mod.plan(self.traffic, rng)
        self.batches.append(rec)
        self.calls = 0
        rec.t_begin = time.perf_counter()
        return rec

    def attack_call(self, x: torch.Tensor) -> None:
        i = self.calls
        self.calls += 1
        if self.capturing:
            self.step_mod.on_victim_call(self.current.step, i, x)
        if (self.tracer is not None
                and len(self.batches) == self.traffic["trace_batch"] + 1):
            first, count = self.traffic["trace_calls"]
            if i == first:
                self.current.pre_trace_s = (self.tracer.start()
                                            - self.current.t_begin)
            elif i == first + count:
                self.tracer.stop()


class Window:
    """The iterator eval_asr reads: batches of the pool, in turn, until
    ``seconds`` have passed since the first was handed out; it times each
    batch from its hand-out to the next request."""

    def __init__(self, pool, labels, batch: int, seconds: float,
                 recorder: Recorder):
        self.pool, self.labels, self.batch = pool, labels, batch
        self.seconds, self.recorder = seconds, recorder
        self.t0 = None

    def __iter__(self):
        n = self.pool.shape[0] // self.batch
        self.t0 = time.perf_counter()
        last, i = self.t0, 0
        while True:
            now = time.perf_counter()
            if i > 0:
                self.recorder.batches[-1].batch_s = now - last
            if now - self.t0 >= self.seconds:
                return
            last = now
            j = (i % n) * self.batch
            yield (self.pool[j:j + self.batch],
                   self.labels[j:j + self.batch])
            i += 1


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""
    cell: Cell
    seed: int
    setup_s: float
    setup_parts: dict                  # seconds of each part of set-up
    window_s: float
    examples: int
    batches: List[BatchRecord]
    eval_metrics: dict
    memory_peak_bytes: int
    trace: Optional[object] = None     # tracing.Trace of a traced run

    def pre_trace_attack(self):
        """(attack seconds, attack iterations) before the profiler's
        start: the attack spans of the batches before the traced one
        (``trace_batch``), and the traced batch's from its start to the
        profiler's (its first ``trace_calls[0] - prep_calls``
        iterations); (0, 0) in a run that traced nothing."""
        tr = self.cell.traffic
        b = tr["trace_batch"]
        if len(self.batches) <= b or self.batches[b].pre_trace_s is None:
            return 0.0, 0
        return (sum(x.attack_s for x in self.batches[:b])
                + self.batches[b].pre_trace_s,
                tr["iterations_per_batch"] * b + tr["trace_calls"][0]
                - tr["prep_calls"])

    def post_trace_attack(self):
        """(attack seconds, attack iterations) of the whole batches after
        the traced one."""
        tr = self.cell.traffic
        done = [x for x in self.batches[tr["trace_batch"] + 1:]
                if x.attack_s is not None]
        return (sum(x.attack_s for x in done),
                tr["iterations_per_batch"] * len(done))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", block: int = 32) -> dict:
    """Set up, measure, trace and check one run of ``cell`` on
    ``device``: ``{"run": Run, "params": the weights, "numbers": the
    comparison's readings, "failed": clouds with no valid result}``."""
    from hitadv_torch.eval import build_attack
    from hitadv_torch.evaluation import eval_asr
    from hitadv_torch.ops import _build

    from bench_port import checks, tracing
    from bench_port.trees import make_tree

    dev = torch.device(device)
    traffic, config = cell.traffic, cell.config
    B, N = traffic["batch"], traffic["points"]
    parts = {"imports": time.perf_counter() - t_start}

    def part(name):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t_start - sum(parts.values())

    # set-up: the card, the extensions (built once per checkout), the
    # weights and the pool from the seed, one short attack at the cell's
    # shapes
    torch.empty(1, device=dev)
    part("device")
    if dev.type == "cuda":
        _build.build_all()
    part("extensions")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = make_tree(cell.config_mod.tree(config), gen, dev)
    victim = cell.config_mod.port_victim(config, params, dev)
    pool, labels = make_clouds(traffic["pool_batches"] * B, N,
                               traffic["classes"], gen, dev)
    part("weights_and_pool")
    step_mod = step_module(traffic["step_check"])
    tracer = tracing.Tracer(dev) if trace else None
    rec = Recorder(seed, traffic, step_mod)
    hooks = step_mod.install(rec)

    def attacked(x):
        rec.attack_call(x)
        return victim(x)

    def judge(x):
        out = victim(x)
        rec.current.judged.append(out)
        return out

    def timed(attack):
        def attack_fn(points, labels_, generator):
            r = rec.begin(points, labels_)
            t0 = time.perf_counter()
            rec.capturing = True
            r.result = attack(points, labels_, generator)
            rec.capturing = False
            if trace and dev.type == "cuda":
                torch.cuda.synchronize()
            r.attack_s = time.perf_counter() - t0
            return r.result
        return attack_fn

    warm = build_attack(eval_config(traffic, dev, traffic["warmup_attack"]),
                        attacked, victim)
    eval_asr(judge, timed(warm), [(pool[:B], labels[:B])], seed=seed,
             uniform_k=traffic["uniform_k"], verbose=False, device=dev)
    attack = build_attack(eval_config(traffic, dev), attacked, victim)
    rec.batches.clear()
    part("warm_up")
    if tracer is not None:
        tracer.warm()
        tracer.watch_kernels()
        rec.tracer = tracer
    part("profiler")
    setup_s = time.perf_counter() - t_start

    window = Window(pool, labels, B, seconds, rec)
    metrics = eval_asr(judge, timed(attack), window, seed=seed,
                       uniform_k=traffic["uniform_k"], verbose=False,
                       device=dev)
    window_s = time.perf_counter() - window.t0
    if tracer is not None:
        tracer.stop()
        tracer.unwatch_kernels()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    step_mod.uninstall(hooks)
    del attack, warm
    run = Run(cell=cell, seed=seed, setup_s=setup_s, setup_parts=parts,
              window_s=window_s,
              examples=B * len(rec.batches), batches=rec.batches,
              eval_metrics=metrics, memory_peak_bytes=peak,
              trace=tracer.reduce() if tracer is not None else None)
    del victim, pool, labels
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the comparison with the plain reference, after the window
    failed = checks.failed_clouds(run, traffic)
    numbers = checks.readings(run, params, block=block)
    return dict(run=run, params=params, numbers=numbers, failed=failed)
