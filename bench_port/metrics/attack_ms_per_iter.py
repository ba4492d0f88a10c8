"""The attack span per iteration (binary steps times iterations, or
steps), preparation included (host clock, ended by a synchronise),
before the profiler's start: the batches before the traced one and the
traced batch up to the profiler's start. What runs after the profiler
has run is left out."""


def read(run):
    seconds, iters = run.pre_trace_attack()
    return 1e3 * seconds / iters if iters > 0 and seconds > 0 else None
