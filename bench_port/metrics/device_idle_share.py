"""The share of an attack iteration in which no operation runs on the
device: 1 - (the union of the device operations' intervals in the traced
range, per traced iteration) / (the attack's host-clock seconds per
iteration before the profiler's start), in percent. The profiler's own
host cost, which lengthens the traced range, stays out (device trace
and host clock of the same run)."""


def read(run):
    t = run.trace
    seconds, iters = run.pre_trace_attack()
    if t is None or iters <= 0 or seconds <= 0:
        return None
    busy = t.busy_s / run.cell.traffic["trace_calls"][1]
    return 100.0 * (1.0 - busy / (seconds / iters))
