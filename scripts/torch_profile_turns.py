#!/usr/bin/env python3
"""Device time per Adam iteration of the port's paths, in turns over
source trees, on one CUDA card.

    python3 scripts/torch_profile_turns.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout (the same tree may come more than
once). For each, in the order given, a fresh process started in that
tree imports its own ``chip_smoke.py`` and ``hitadv_torch``, builds its
kernels and profiles one Adam iteration (`chip_smoke.phase_profile`, the
10- and 30-iteration attacks differenced) of HiT-ADV against DGCNN and
PointConv (B=16, bf16) and of CW-Perturb and CW-UKNN against PointNet
(B=64, bf16). It prints one JSON line a run (device and host wall ms per
iteration, the device's idle share, the kernels that take the device
time) and, last, a line of the device ms per iteration by path and run.
Taking the trees in turns on one card (parent, change, change, parent)
lets two versions be compared inside one call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
import hitadv_torch  # noqa: F401  (sets the TF32 policy)
from hitadv_torch.ops import _build

if not torch.cuda.is_available():
    sys.exit("no CUDA device")
_build.build_all()
dev = torch.device("cuda")
out = {}
for name, label in (("dgcnn", "DGCNN"), ("pointconv", "PointConv")):
    out[label] = cs.phase_profile(torch, dev, cs.hit_adv_of(
        dev, cs._victim(torch, dev, name, torch.bfloat16)), 16)
out.update(cs.phase_profile_cw(torch, dev))
print("PROFILE " + json.dumps(out))
"""


def main(trees) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    table = {}
    for i, tree in enumerate(trees):
        proc = subprocess.run([sys.executable, "-c", CHILD],
                              cwd=os.path.abspath(tree), text=True,
                              capture_output=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("PROFILE ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            print(f"run {i} in {tree} failed ({proc.returncode})",
                  file=sys.stderr)
            return 1
        prof = json.loads(lines[-1][len("PROFILE "):])
        print(json.dumps({"run": i, "tree": tree, "profile": prof}),
              flush=True)
        for path, p in prof.items():
            table.setdefault(path, []).append(p["device_ms_per_iter"])
    print(json.dumps({"trees": trees, "device_ms_per_iter": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
