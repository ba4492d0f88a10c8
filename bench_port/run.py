"""The port's benchmark: one run of one cell.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.
Set-up (the port's CUDA extensions from their build directory in the
checkout, the victim's weights and a pool of clouds drawn on the card
from the seed, a short warm-up attack at the cell's shapes) is timed as
``setup_s``; then `hitadv_torch.evaluation.eval_asr` runs the attack that
`hitadv_torch.eval.build_attack` builds for the cell's traffic, batch
after batch, until ``--seconds`` have passed, and ``examples_per_s`` is
every example of the window over its wall time. With ``--trace 1`` the
per-layer metrics are read instead, from host-clock spans around the
calls into each layer and a profiler trace of a range of one batch's
attack. After the window the plain reference
(`bench_port/reference`) checks what the window produced
(`bench_port/checks.py`); each number compared is printed with its limit
as the last lines of standard error and under ``checks`` in the result,
the last line of standard output.

Exits non-zero, printing no result, without enough CUDA devices, and
when JAX or the JAX package was loaded by the time the result is made.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_args(argv=None):
    p = argparse.ArgumentParser("bench_port")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cards_missing(chips: int):
    """Why the run cannot measure, or None."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device is available"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} CUDA devices, "
                f"{torch.cuda.device_count()} are available")
    return None


def result_line(out: dict, trace: bool) -> dict:
    """The result line's object of `harness.run_cell`'s output."""
    import torch

    from bench_port import checks, harness

    run = out["run"]
    cell = run.cell
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = harness.metric_module(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    verdict = checks.verdict(out["numbers"]["numbers"], cell.limits)
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name(0),
              "count": int(cell.entry["chips"]),
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": all(ok for *_, ok in verdict),
            "attempted": run.examples, "failed": out["failed"],
            "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        ops = sorted(run.trace.op_s.items(), key=lambda kv: -kv[1])
        line["breakdown"] = {
            "device_ops": [[k, v] for k, v in ops[:10]],
            "idle_gaps": [[k, v] for k, v in run.trace.idle_gaps[:10]]}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit, _ in verdict}
    return line, verdict


def main(argv=None) -> int:
    args = parse_args(argv)
    from bench_port import harness

    cell = harness.load_cell(args.workload)
    why = cards_missing(int(cell.entry["chips"]))
    if why is not None:
        print(f"bench_port: {why}; nothing measured", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           T_START)
    line, verdict = result_line(out, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"bench_port: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    run = out["run"]
    parts = ", ".join(f"{k} {v:.3f}" for k, v in run.setup_parts.items())
    print(f"set-up seconds: {parts}", file=sys.stderr)
    print("batch seconds: " + ", ".join(f"{b.batch_s:.3f}" for b in
                                        run.batches if b.batch_s),
          file=sys.stderr)
    if args.trace:
        for when, (s, n) in (("before", run.pre_trace_attack()),
                             ("after", run.post_trace_attack())):
            if n:
                print(f"attack ms an iteration {when} the profiler: "
                      f"{1e3 * s / n!r} over {n}", file=sys.stderr)
    for name, value, limit, ok in verdict:
        print(f"check {name}: {value!r} against the limit {limit!r}: "
              f"{'within' if ok else 'NOT within'}", file=sys.stderr)
    print(json.dumps(line, allow_nan=True))
    return 0 if all(math.isfinite(m["value"])
                    for m in line["metrics"].values()) else 4


if __name__ == "__main__":
    sys.exit(main())
