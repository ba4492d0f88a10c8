"""The exact kNN kernel (`ops/csrc/knn.cu`) against its roofline: the
least time of its traced calls (each the larger of (2 C + 3) B Nq N
operations, every pair's distance over the width and its comparison, at
the dtype's peak, and its bytes, both inputs and both outputs once, at
the memory rate) over the device time of its kernels, in percent
(device trace, call shapes from the wrapper `kernels.knn`). Where the
trace holds a few launches more or fewer than the calls make (one traced
run in nine lost or gained some), the bound is scaled by the share
traced; past 5% the reading is left out."""

import sys

from bench_port.peaks import bound_s

KERNELS = ("knn_xyz_kernel", "knn_feat_kernel")


def read(run):
    t = run.trace
    if t is None:
        return None
    calls = t.kernel_calls.get("knn", [])
    time_s = n = 0
    for k in KERNELS:
        s, c = t.seconds_of(k)
        time_s, n = time_s + s, n + c
    launches = sum(-(-k // 64) for *_, k, _ in calls)
    if n != launches:
        print(f"knn_roofline: {n} launches traced, {launches} from the "
              f"calls", file=sys.stderr)
    if not calls or time_s <= 0 or abs(n - launches) > 0.05 * launches:
        return None
    least = 0.0
    for B, Nq, C, N, k, dtype in calls:
        size = 2 if "bfloat16" in dtype else 4
        nbytes = (B * Nq * C + B * N * C) * size + B * Nq * k * 8
        least += bound_s((2.0 * C + 3) * B * Nq * N, nbytes,
                         "torch.float32")
    return 100.0 * least * (n / launches) / time_s
