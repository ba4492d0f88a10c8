"""Shared pieces of the benchmark's tests: a cell cut to a size the CPU
holds, run through the harness on the CPU."""

import contextlib
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(cell):
    """``cell`` at 4 clouds of 256 points, 4 attack iterations (HiT-ADV:
    two binary steps of two)."""
    tr = cell.traffic
    tr.update(batch=4, points=256, pool_batches=2, iterations_per_batch=4)
    if tr["step_check"] == "hitadv":
        tr["attack"].update(binary_step=2, num_iter=2)
        tr.update(trace_batch=0, trace_calls=[2, 2])
    else:
        tr["attack"].update(num_iter=4)
        tr.update(trace_batch=0, trace_calls=[0, 3])
    return cell


@pytest.fixture
def run_tiny():
    """``run_tiny(cell_name, fault=None, trace=False)`` -> run_cell's
    output for the cell at the tiny size on the CPU, with ``fault`` (a
    context manager) around it."""
    import torch

    from bench_port import harness

    torch.set_num_threads(4)

    def go(name, fault=None, trace=False, seed=2 ** 31 + 77):
        cell = tiny(harness.load_cell(name))
        with fault or contextlib.nullcontext():
            return harness.run_cell(cell, seed, 0.01, trace,
                                    time.perf_counter(), device="cpu",
                                    block=2)
    return go
