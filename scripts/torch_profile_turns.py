#!/usr/bin/env python3
"""Device time per Adam iteration of the port's paths, in turns over
source trees, on one CUDA card.

    python3 scripts/torch_profile_turns.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout (the same tree may come more than
once). For each, in the order given, a fresh process started in that
tree imports its own ``chip_smoke.py`` and ``hitadv_torch``, builds its
kernels and profiles one Adam iteration (`chip_smoke.phase_profile`, the
10- and 30-iteration attacks differenced) of HiT-ADV against PointNet
(B=64, bf16, with ``blend="kernel"`` and its control ``blend="field"``),
DGCNN and PointConv (B=16, bf16) and of CW-Perturb and CW-UKNN against
PointNet (B=64, bf16); then it times the negdt blend pair, the kernels of
``blend="kernel"``, on the device (`chip_smoke.graph_ms`) at HiT-ADV's
shape and at `BLEND_SHAPES`. It prints one JSON line a run (device and
host wall ms per iteration, the device's idle share, the kernels that
take the device time, the pair's ms by shape) and, last, a line of the
device ms per iteration by path and run and one of the pair's ms by shape
and run. Taking the trees in turns on one card (parent, change, change,
parent) lets two versions be compared inside one call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# (B, N, Cn) of the negdt blend pair's timing: HiT-ADV's shape, then
# off-tile shapes that every version of the pair takes (Cn <= 3072)
BLEND_SHAPES = ((64, 1024, 192), (3, 1000, 192), (2, 1, 7), (2, 300, 1),
                (3, 257, 45), (3, 1001, 195), (3, 100, 100), (2, 300, 256),
                (2, 300, 257), (1, 4100, 64), (2, 300, 3072))

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
import hitadv_torch  # noqa: F401  (sets the TF32 policy)
from hitadv_torch.ops import _build
from hitadv_torch.ops import kernels as K

if not torch.cuda.is_available():
    sys.exit("no CUDA device")
_build.build_all()
dev = torch.device("cuda")
out = {}
for blend in ("kernel", "field"):
    out[f"PointNet blend={blend}"] = cs.phase_profile(torch, dev, cs.hit_adv_of(
        dev, cs._victim(torch, dev, "pointnet", torch.bfloat16), blend), 64)
for name, label in (("dgcnn", "DGCNN"), ("pointconv", "PointConv")):
    out[label] = cs.phase_profile(torch, dev, cs.hit_adv_of(
        dev, cs._victim(torch, dev, name, torch.bfloat16)), 16)
out.update(cs.phase_profile_cw(torch, dev))
print("PROFILE " + json.dumps(out))
rng = np.random.RandomState(11)
ms = {}
for B, N, Cn in json.loads(sys.argv[1]):
    fwd = cs._blend_inputs(torch, dev, rng, B, N, Cn)
    bwd = fwd + (torch.randn(B, N, 3, device=dev), torch.randn(B, N, device=dev))
    ms[f"forward {B}x{N}x{Cn}"] = cs.graph_ms(lambda: K.gaussian_blend_negdt(*fwd))
    ms[f"backward {B}x{N}x{Cn}"] = cs.graph_ms(
        lambda: K.gaussian_blend_negdt_bwd(*bwd))
print("BLEND " + json.dumps(ms))
"""


def main(trees) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    table, blend = {}, {}
    for i, tree in enumerate(trees):
        proc = subprocess.run([sys.executable, "-c", CHILD,
                               json.dumps(BLEND_SHAPES)],
                              cwd=os.path.abspath(tree), text=True,
                              capture_output=True)
        found = {key: [ln[len(key) + 1:] for ln in proc.stdout.splitlines()
                       if ln.startswith(key + " ")]
                 for key in ("PROFILE", "BLEND")}
        if proc.returncode != 0 or not all(found.values()):
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            print(f"run {i} in {tree} failed ({proc.returncode})",
                  file=sys.stderr)
            return 1
        prof = json.loads(found["PROFILE"][-1])
        ms = json.loads(found["BLEND"][-1])
        print(json.dumps({"run": i, "tree": tree, "profile": prof,
                          "blend_pair_ms": ms}), flush=True)
        for path, p in prof.items():
            table.setdefault(path, []).append(p["device_ms_per_iter"])
        for shape, t in ms.items():
            blend.setdefault(shape, []).append(t)
    print(json.dumps({"trees": trees, "blend_pair_ms": blend}))
    print(json.dumps({"trees": trees, "device_ms_per_iter": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
