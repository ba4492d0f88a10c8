"""Seconds from the process's start to the window's: imports, the
extensions' load (and build, in a checkout's first run), the weights,
the pool, and the warm-up attack (host clock)."""


def read(run):
    return run.setup_s
