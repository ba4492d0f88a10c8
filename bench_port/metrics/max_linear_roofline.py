"""The fused linear + global max-pool kernel (`ops/csrc/max_linear_fwd.cu`)
against its roofline: the least time of its traced calls (each the
larger of 2 B N K C operations at the dtype's peak and its bytes, h, w,
the bias and both outputs once, at the memory rate) over the device
time of its kernels, in percent (device trace, call shapes from the
wrapper `kernels.max_linear`). Where the trace holds a few launches more
or fewer than the calls, the bound is scaled by the share traced; past
5% the reading is left out."""

import sys

from bench_port.peaks import bound_s

KERNELS = ("maxlin_f32_kernel", "maxlin_wgmma_kernel")


def read(run):
    t = run.trace
    if t is None:
        return None
    calls = t.kernel_calls.get("max_linear", [])
    time_s = n = 0
    for k in KERNELS:
        s, c = t.seconds_of(k)
        time_s, n = time_s + s, n + c
    if n != len(calls):
        print(f"max_linear_roofline: {n} launches traced, {len(calls)} "
              f"calls", file=sys.stderr)
    if not calls or time_s <= 0 or abs(n - len(calls)) > 0.05 * len(calls):
        return None
    least = 0.0
    for B, N, K, C, dtype in calls:
        size = 2 if "bfloat16" in dtype else 4
        nbytes = (B * N * K + K * C) * size + C * 4 + B * C * 8
        least += bound_s(2.0 * B * N * K * C, nbytes, dtype)
    return 100.0 * least * (n / len(calls)) / time_s
