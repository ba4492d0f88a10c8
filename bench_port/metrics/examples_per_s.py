"""Clouds attacked, judged and scored per second: every example of every
batch of the window over the window's wall time (host clock)."""


def read(run):
    return run.examples / run.window_s
