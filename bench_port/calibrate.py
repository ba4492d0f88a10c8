"""The readings that a cell's limits are set from: for each seed, one run
of the cell (a window of ``--seconds``) compared with the reference, as
the benchmark compares it, and the control, the reference in TF32 put in
the program's place, compared the same way on the same inputs and
states. Seeds run in one process, so the set-up is paid once.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--out calibrate_<cell>.json]

Prints each seed's numbers and the spread of its per-cloud errors, and
writes them all to ``--out``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def spread(values) -> dict:
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        return {}
    return {"n": int(v.size), "max": float(v[-1]),
            "top": [float(x) for x in v[::-1][:8]],
            "q50": float(np.quantile(v, 0.5)),
            "q90": float(np.quantile(v, 0.9)),
            "q99": float(np.quantile(v, 0.99)),
            "nonzero": int(np.count_nonzero(v))}


def summary(readings: dict) -> dict:
    d = readings["detail"]
    return {"numbers": readings["numbers"],
            "judge": spread(d["judge"]), "metric": [float(x) for x in
                                                      d["metric"]],
            "step": spread(d["step"])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("bench_port.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--controls", type=int, default=3,
                   help="read the control on the first this many seeds")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from bench_port import checks, harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        cell = harness.load_cell(args.workload)
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, args.seconds, False, t0)
        run = out["run"]
        ctl = (checks.readings(run, out["params"], control=checks.tf32)
               if i < args.controls else None)
        row = {"seed": seed, "batches": len(run.batches),
               "examples_per_s": run.examples / run.window_s,
               "failed": out["failed"],
               "sound": summary(out["numbers"]),
               "control": summary(ctl) if ctl else None,
               "check_s": time.perf_counter() - t0 - run.setup_s
               - run.window_s}
        if cell.traffic["step_check"] == "hitadv":
            b = run.batches[checks.checked_batch(run)]
            row["centres_differ"] = b.step.get("centres_differ")
        rows.append(row)
        print(json.dumps({k: row[k] for k in ("seed", "batches",
                                              "examples_per_s", "failed",
                                              "check_s")}), flush=True)
        for side in ("sound", "control"):
            s = row[side]
            if s is None:
                continue
            print(f"  {side}: {s['numbers']} judge q50/q90/q99/max "
                  f"{s['judge'].get('q50')}/{s['judge'].get('q90')}/"
                  f"{s['judge'].get('q99')}/"
                  f"{s['judge'].get('max')} metric {s['metric']} step "
                  f"q50/q90/q99/max {s['step'].get('q50')}/"
                  f"{s['step'].get('q90')}/{s['step'].get('q99')}/"
                  f"{s['step'].get('max')} nonzero "
                  f"{s['step'].get('nonzero')}", flush=True)
        del out, run, ctl
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "seconds": args.seconds,
                       "card": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
