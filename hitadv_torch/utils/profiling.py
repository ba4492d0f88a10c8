"""Timing and tracing (port of `hitadv_tpu/utils/profiling.py`).

`PhaseTimer` accumulates wall-clock seconds per named phase, as the
reference's forward/backward/update/clip counters printed every 100
iterations (`CW/Perturb.py:89-92,160-173`, `ShapeAttack/HiT_ADV.py:
150-153,248-260`); with ``sync=True`` a phase waits for the card's queued
work before it stops its clock. `trace` records a `torch.profiler` trace
(Chrome trace JSON, viewable in Perfetto or TensorBoard), `annotate`
names a region in it, and `device_timer` times a block on the card by a
pair of CUDA events (on the CPU, by the wall clock).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Wall-clock seconds per named phase; `summary` prints them as the
    reference's counters do, `reset` clears them."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                _sync()                  # the phase's kernels have finished
            self.totals[name] += time.perf_counter() - t0

    def summary(self) -> str:
        total = sum(self.totals.values())
        parts = ", ".join(f"{k}: {v:.2f}" for k, v in self.totals.items())
        return f"total time: {total:.2f}, {parts}"

    def reset(self) -> None:
        self.totals.clear()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (host, and the card when there is one) and write
    its Chrome trace to ``<log_dir>/trace.json``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region of the trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def device_timer(device: Optional[torch.device] = None):
    """Time a block: yields a dict whose ``"ms"`` is filled on exit. On a
    CUDA device (the current one when ``device`` is None and a card is
    there) by a pair of events on its current stream, so the time is the
    card's from the block's first queued kernel to its last; on the CPU by
    the wall clock."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    out: Dict[str, float] = {}
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield out
        finally:
            end.record()
            end.synchronize()
            out["ms"] = start.elapsed_time(end)
        return
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        out["ms"] = (time.perf_counter() - t0) * 1e3
