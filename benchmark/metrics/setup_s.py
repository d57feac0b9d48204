"""Seconds from the process's start to the window: imports, kernel build or
cache load, weights, the rendered pool, the reference swing, warm-up."""


def read(run):
    return run.setup_s
