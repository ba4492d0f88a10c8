#!/usr/bin/env python3
"""Device time per Adam iteration of the port's paths, and device time of
chosen kernels, in turns over source trees, on one CUDA card.

    python3 scripts/torch_profile_turns.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout (the same tree may come more than
once). For each, in the order given, a fresh process started in that
tree imports its own ``chip_smoke.py`` and ``hitadv_torch``, builds its
kernels and profiles one Adam iteration (`chip_smoke.phase_profile`, the
10- and 30-iteration attacks differenced) of HiT-ADV against PointNet
(B=64, bf16, with ``blend="kernel"`` and ``blend="field"``), DGCNN,
PointNet++ and PointConv (B=16, bf16) and of CW-Perturb and CW-UKNN
against PointNet (B=64, bf16); then it times kernels on the device
(`chip_smoke.graph_ms`, the same inputs in every tree): the ball query at
PointNet++'s two stages and the evaluation's five disks, the fused blend
pair at HiT-ADV's shape and at `chip_smoke.FUSED_LARGE`, the negdt
blend pair at HiT-ADV's shape, and the three scatters of the shared
counting sort at every path shape (the tree's own kernel phases). It prints one JSON line a run (device and host wall ms per
iteration, the device's idle share, the kernels that take the device
time, the kernels' ms) and, last, a line of the kernels' ms by run and
one of the device ms per iteration by path and run. Taking the trees in
turns on one card (parent, change, change, parent) lets two versions be
compared inside one call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
import hitadv_torch  # noqa: F401  (sets the TF32 policy)
from hitadv_torch.data import synthetic_clouds
from hitadv_torch.losses.geoa3 import uniform_disks
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
for name, label in (("dgcnn", "DGCNN"), ("pointnet++", "PointNet++"),
                    ("pointconv", "PointConv")):
    out[label] = cs.phase_profile(torch, dev, cs.hit_adv_of(
        dev, cs._victim(torch, dev, name, torch.bfloat16)), 16)
out.update(cs.phase_profile_cw(torch, dev))
print("PROFILE " + json.dumps(out))

ms = {}
pts, _ = synthetic_clouds(64, 1024, seed=0)
clouds = torch.from_numpy(pts[..., :3].copy()).to(dev)
xyz = clouds[:16].contiguous()
c1 = cs._sa_centres(K, torch, xyz, 512)
c2 = cs._sa_centres(K, torch, c1, 128)
for p_, c_, r, ns in ((xyz, c1, 0.2, 32), (c1, c2, 0.4, 64)):
    ms[f"ball_query {cs.shape_of((p_, c_, r, ns))}"] = cs.graph_ms(
        lambda: K.ball_query(p_, c_, r, ns))
cen = cs._sa_centres(K, torch, clouds, 51)
for _, ns, r, _ in uniform_disks(1024):
    ms[f"ball_query {cs.shape_of((clouds, cen, r, ns))}"] = cs.graph_ms(
        lambda: K.ball_query(clouds, cen, r, ns))
rng = np.random.RandomState(13)
for B, N, Cn in ((64, 1024, 192), cs.FUSED_LARGE):
    fwd, gs = cs._fused_inputs(torch, dev, rng, B, N, Cn)
    ms[f"gaussian_blend_fused {B}x{N}x{Cn}"] = cs.graph_ms(
        lambda: K.gaussian_blend_fused(*fwd), reps=10)
    ms[f"gaussian_blend_fused_bwd {B}x{N}x{Cn}"] = cs.graph_ms(
        lambda: K.gaussian_blend_fused_bwd(*fwd, *gs), reps=10)
    del fwd, gs
    torch.cuda.empty_cache()
# the scatters of the shared CSR (rows 6, 7b, 9b) at every path shape,
# through the tree's own kernel phases
R = cs.KernelRecord(K, torch)
cs.phase_scatter_add_rows(K, R, torch, dev, clouds)
cs.phase_graph_max_pool(K, R, torch, dev)
cs.phase_gather_group(K, R, torch, dev)
for name in ("scatter_add_rows", "graph_max_pool_bwd", "scatter_add_group"):
    for shape, case in R.cases.get(name, {}).items():
        ms[f"{name} {shape}"] = case["ms"]
fwd = cs._blend_inputs(torch, dev, rng, 64, 1024, 192)
bwd = fwd + (torch.randn(64, 1024, 3, device=dev),
             torch.randn(64, 1024, device=dev))
ms["gaussian_blend_negdt 64x1024x192"] = cs.graph_ms(
    lambda: K.gaussian_blend_negdt(*fwd))
ms["gaussian_blend_negdt_bwd 64x1024x192"] = cs.graph_ms(
    lambda: K.gaussian_blend_negdt_bwd(*bwd))
print("KERNELS " + json.dumps(ms))
"""


def main(trees) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    table, kernels = {}, {}
    for i, tree in enumerate(trees):
        proc = subprocess.run([sys.executable, "-c", CHILD],
                              cwd=os.path.abspath(tree), text=True,
                              capture_output=True)
        found = {key: [ln[len(key) + 1:] for ln in proc.stdout.splitlines()
                       if ln.startswith(key + " ")]
                 for key in ("PROFILE", "KERNELS")}
        if proc.returncode != 0 or not all(found.values()):
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            print(f"run {i} in {tree} failed ({proc.returncode})",
                  file=sys.stderr)
            return 1
        prof = json.loads(found["PROFILE"][-1])
        ms = json.loads(found["KERNELS"][-1])
        print(json.dumps({"run": i, "tree": tree, "profile": prof,
                          "kernel_ms": ms}), flush=True)
        for path, p in prof.items():
            table.setdefault(path, []).append(p["device_ms_per_iter"])
        for shape, t in ms.items():
            kernels.setdefault(shape, []).append(t)
    print(json.dumps({"trees": trees, "kernel_ms": kernels}))
    print(json.dumps({"trees": trees, "device_ms_per_iter": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
