"""The port's spans and counters.

Spans are off by default; `enable` turns them on. Then each
``with span(name):`` records its name, its parent (the span open around
it), the batch it belongs to (the ``batch`` of the span open around it
that gave one: `evaluation.eval_asr`'s batch index), its host start and
end (``time.perf_counter_ns()``) and, where spans were enabled for a
CUDA device, a pair of CUDA events recorded on that device's stream of
the moment spans were enabled, taken from a pool that is reused once
they are resolved.

Nothing here waits for the device inside a span. The events are
resolved where the host already waits, after ``eval_asr``'s read of a
batch (`resolve`), or by `collect`, which synchronises once: a
reference event recorded there, once complete, ties the closed spans to
the host clock. Each span's device start and end is then the host time
at which the reference had completed, less the elapsed time from the
span's event to the reference; that arithmetic (two CUDA calls a span)
runs when the records are read (`records`, `summary`), not between
batches, where the card would wait for it. Without a card the device
fields are None: no device time is ever taken from the host clock.

`to_trace_ns` puts a host time on the clock of a `torch.profiler`
Chrome trace (``ts`` in microseconds times 1e3 plus
``baseTimeNanoseconds``: Unix nanoseconds), by the offset `enable`
records. While a profiler records, a span also enters
`torch.profiler.record_function` under its name, so it appears in the
trace as a ``user_annotation`` and the kernels and idle gaps line up
with the program's phases.

Counters (`count`, kept only while spans are on): ``eval.batches``,
``eval.examples``, ``attack.iterations``, ``attack.binary_steps``;
`counters` adds `hitadv_torch.ops.kernels.LAUNCHES` as
``kernels.launches.<name>``, read from that dict when called.

When off, `span` returns one shared no-op context manager after one
flag test and `count` is one flag test: no event, no
``record_function``, no allocation. Spans are recorded from one thread.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, List, Optional

import torch

_ON = False
_STREAM = None           # the stream spans record CUDA events on, or None
_TRACE_OFFSET_NS = 0     # profiler trace clock minus perf_counter_ns
_BATCH: Optional[int] = None
_RECORDS: List["_Span"] = []
_STACK: List[int] = []   # indices in _RECORDS of the open spans
_PENDING: List["_Span"] = []     # closed spans not yet resolved
_RESOLVED: List[tuple] = []      # (reference event, its host ns, spans)
_POOL: List["torch.cuda.Event"] = []
_COUNTERS: Dict[str, int] = {}

FIELDS = ("name", "parent", "batch", "host_start_ns", "host_end_ns",
          "device_start_ns", "device_end_ns")


_OFF = contextlib.nullcontext()  # every span while spans are off


def _event() -> "torch.cuda.Event":
    return _POOL.pop() if _POOL else torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = FIELDS + ("_sets_batch", "_outer_batch", "_annotation",
                          "_start", "_end")

    def __init__(self, name: str, batch: Optional[int]):
        self.name = name
        self._sets_batch = batch is not None
        self.batch = batch if batch is not None else _BATCH
        self.device_start_ns = self.device_end_ns = None
        self._annotation = self._start = self._end = None

    def __enter__(self):
        global _BATCH
        self.parent = _STACK[-1] if _STACK else None
        _STACK.append(len(_RECORDS))
        _RECORDS.append(self)
        if self._sets_batch:
            self._outer_batch, _BATCH = _BATCH, self.batch
        if torch.autograd._profiler_enabled():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.host_start_ns = time.perf_counter_ns()
        if _STREAM is not None:
            self._start = _event()
            self._start.record(_STREAM)
        return self

    def __exit__(self, *exc):
        global _BATCH
        if self._start is not None:
            self._end = _event()
            self._end.record(_STREAM)
            _PENDING.append(self)
        self.host_end_ns = time.perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        if self._sets_batch:
            _BATCH = self._outer_batch
        _STACK.pop()
        return False


def span(name: str, batch: Optional[int] = None):
    """A context manager that records the span ``name`` while spans are
    on; ``batch`` names the batch of this span and of those inside it."""
    if not _ON:
        return _OFF
    return _Span(name, batch)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while spans are on."""
    if _ON:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def enable(device=None) -> None:
    """Turn spans and counters on, with device times on a CUDA
    ``device`` (default: the card when there is one), from events on its
    current stream; raises for a CUDA device without a card. Records the
    host clock's offset to the profiler trace's."""
    global _ON, _STREAM, _TRACE_OFFSET_NS
    dev = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("profiling.enable: no CUDA device is available")
    _TRACE_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
    _STREAM = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    _ON = True


def disable() -> None:
    """Turn spans and counters off; what they recorded stays."""
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def reset() -> None:
    """Forget every span and counter, the kernel launches included."""
    from hitadv_torch.ops import kernels

    for ref, _, spans in _RESOLVED:
        _POOL.append(ref)
        _PENDING.extend(spans)
    _RESOLVED.clear()
    for s in _PENDING:
        _POOL.extend((s._start, s._end))
        s._start = s._end = None
    _PENDING.clear()
    _RECORDS.clear()
    _STACK.clear()
    _COUNTERS.clear()
    kernels.reset_launches()


def resolve() -> None:
    """Tie the closed spans to the host clock. Call only where the device
    has done every span's work (after a read to the host): it waits for
    one reference event recorded now."""
    if not _PENDING:
        return
    ref = _event()
    ref.record(_STREAM)
    ref.synchronize()
    _RESOLVED.append((ref, time.perf_counter_ns(), _PENDING[:]))
    _PENDING.clear()


def _place() -> None:
    """The device times of the resolved spans; their events go back to
    the pool."""
    for ref, t_ref, spans in _RESOLVED:
        for s in spans:
            s.device_start_ns = t_ref - round(
                s._start.elapsed_time(ref) * 1e6)
            s.device_end_ns = t_ref - round(s._end.elapsed_time(ref) * 1e6)
            _POOL.extend((s._start, s._end))
            s._start = s._end = None
        _POOL.append(ref)
    _RESOLVED.clear()


def collect() -> None:
    """Resolve every closed span: synchronises the card once."""
    if _PENDING:
        torch.cuda.synchronize()
        resolve()
    _place()


def to_trace_ns(host_ns: int) -> int:
    """A ``perf_counter_ns`` time on the profiler trace's clock (Unix
    nanoseconds)."""
    return host_ns + _TRACE_OFFSET_NS


def records() -> List[dict]:
    """Every span recorded since the last `reset`, in the order they
    opened: its `FIELDS` (``parent`` the index of the span around it;
    device times of the spans resolved so far)."""
    _place()
    return [{f: getattr(s, f, None) for f in FIELDS} for s in _RECORDS]


def counters() -> Dict[str, int]:
    """Every counter, and each kernel's launches as
    ``kernels.launches.<name>``."""
    from hitadv_torch.ops import kernels

    out = dict(_COUNTERS)
    out.update({f"kernels.launches.{k}": v
                for k, v in kernels.LAUNCHES.items()})
    return out


def _ms(values: List[int]) -> dict:
    if not values:
        return {"total": None, "median": None}
    return {"total": sum(values) * 1e-6,
            "median": statistics.median(values) * 1e-6}


def summary() -> dict:
    """Per span name its count, total and median host ms and device ms
    (None where a span has no device time), and every counter."""
    by_name: Dict[str, List[dict]] = {}
    for r in records():
        by_name.setdefault(r["name"], []).append(r)
    spans = {}
    for name, rs in by_name.items():
        host = _ms([r["host_end_ns"] - r["host_start_ns"] for r in rs
                    if r["host_end_ns"] is not None])
        dev = _ms([r["device_end_ns"] - r["device_start_ns"] for r in rs
                   if r["device_end_ns"] is not None])
        spans[name] = {"count": len(rs),
                       "host_ms_total": host["total"],
                       "host_ms_median": host["median"],
                       "device_ms_total": dev["total"],
                       "device_ms_median": dev["median"]}
    return {"spans": spans, "counters": counters()}
