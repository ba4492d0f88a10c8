"""The traced range of a ``--trace 1`` run: `torch.profiler` over a range
of attack calls of one batch of the window (the traffic's
``trace_batch`` and ``trace_calls``), with the call shapes of the
kernel wrappers the roofline metrics read, reduced to what the metric
readers and the result line's ``breakdown`` need.

The profiler's Chrome trace is written to a temporary file, read and
deleted: the device operations (kernels, copies, fills) with their
times, and the host's operators, by which each idle gap of the device is
named (the innermost operator running at the gap's middle).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    window_s: float                      # host clock, start to stop
    busy_s: float                        # union of device operations
    op_s: Dict[str, float]               # device seconds by operation name
    op_n: Dict[str, int]                 # launches by operation name
    idle_gaps: List[Tuple[str, float]]   # idle seconds by host operator
    kernel_calls: Dict[str, list]        # wrapper -> [call shape, ...]

    def seconds_of(self, pattern: str) -> Tuple[float, int]:
        """(device seconds, launches) of the operations whose name holds
        ``pattern``."""
        s = sum(v for k, v in self.op_s.items() if pattern in k)
        n = sum(v for k, v in self.op_n.items() if pattern in k)
        return s, n


def _kernel_shape(name, args):
    """The call shape a roofline needs, or None for a call that launches
    none of the kernel's own (kNN of k = 1 on coordinates takes nn.cu)."""
    if name == "max_linear":
        h, w = args[0], args[1]
        return tuple(h.shape) + (w.shape[1], str(h.dtype))
    q, p, k = args[0], args[1], args[2]
    if k == 1 and q.shape[2] <= 4 and q.dtype == torch.float32:
        return None
    return tuple(q.shape) + (p.shape[1], k, str(q.dtype))


class Tracer:
    """Starts and stops the profiler from inside the window, and records
    the call shapes of `kernels.max_linear` and `kernels.knn` while it
    runs."""

    WRAPPED = ("max_linear", "knn")

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.t0 = self.t1 = None
        self.kernel_calls: Dict[str, list] = {n: [] for n in self.WRAPPED}
        self._real = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def warm(self):
        """Start and stop a profiler once, so that the traced range does
        not pay for its first start (set-up)."""
        with torch.profiler.profile(activities=self._activities()):
            torch.ones(1, device=self.device).add_(1)
            self._sync()

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def start(self) -> float:
        """Start the profiler; the host clock once the device has done
        the work queued before it."""
        self._sync()
        t = time.perf_counter()
        if self.prof is not None:
            return t
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.start()
        self.t0 = time.perf_counter()
        return t

    def stop(self):
        if not self.active:
            return
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def watch_kernels(self):
        from hitadv_torch.ops import kernels as K

        for name in self.WRAPPED:
            real = getattr(K, name)
            self._real[name] = real

            def wrapped(*args, _real=real, _name=name):
                if self.active:
                    shape = _kernel_shape(_name, args)
                    if shape is not None:
                        self.kernel_calls[_name].append(shape)
                return _real(*args)

            setattr(K, name, wrapped)

    def unwatch_kernels(self):
        from hitadv_torch.ops import kernels as K

        for name, real in self._real.items():
            setattr(K, name, real)
        self._real.clear()

    def reduce(self) -> Optional[Trace]:
        if self.prof is None or self.t1 is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        return reduce_events(events, self.t1 - self.t0, self.kernel_calls)


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def name_gaps(busy: List[Tuple[float, float]], ops: List[Tuple[float, float,
              str]]) -> Dict[str, float]:
    """Seconds of device idle between the busy intervals (microseconds),
    by the innermost host operator running at each gap's middle
    (``"host"`` when none runs)."""
    ops = sorted(ops)
    starts = [o[0] for o in ops]
    out: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy[:-1], busy[1:]):
        mid = 0.5 * (e0 + s1)
        name = "host"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 200, -1), -1):
            if ops[j][1] >= mid:
                name = ops[j][2]
                break
        out[name] = out.get(name, 0.0) + (s1 - e0) * 1e-6
    return out


def reduce_events(events: list, window_s: float,
                  kernel_calls: Dict[str, list]) -> Trace:
    """The `Trace` of a Chrome trace's events (times in microseconds)."""
    intervals, op_s, op_n, ops = [], {}, {}, []
    for e in events:
        cat, dur = e.get("cat"), e.get("dur")
        if dur is None:
            continue
        if cat in DEVICE_CATS:
            intervals.append((float(e["ts"]), float(e["ts"]) + float(dur)))
            op_s[e["name"]] = op_s.get(e["name"], 0.0) + float(dur) * 1e-6
            op_n[e["name"]] = op_n.get(e["name"], 0) + 1
        elif cat == "cpu_op":
            ops.append((float(e["ts"]), float(e["ts"]) + float(dur),
                        e["name"]))
    busy = merge(intervals)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = sorted(name_gaps(busy, ops).items(), key=lambda kv: -kv[1])
    return Trace(window_s=window_s, busy_s=busy_s, op_s=op_s, op_n=op_n,
                 idle_gaps=gaps, kernel_calls=kernel_calls)
