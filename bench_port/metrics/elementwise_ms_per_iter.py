"""Device time of PyTorch's own elementwise and reduction kernels (ATen's
``elementwise_kernel``, ``vectorized_elementwise_kernel``,
``unrolled_elementwise_kernel``, ``reduce_kernel`` templates) per
traced attack iteration (device trace)."""

PATTERNS = ("elementwise_kernel", "reduce_kernel")


def read(run):
    t = run.trace
    if t is None:
        return None
    s = sum(v for k, v in t.op_s.items()
            if k.startswith("void at::native::")
            and any(p in k for p in PATTERNS))
    return 1e3 * s / run.cell.traffic["trace_calls"][1]
