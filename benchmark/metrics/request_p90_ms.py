"""90th percentile, over every request dispatched in the window, of dispatch to completion (ms)."""

from benchmark import window


def read(run):
    return window.percentile(window.latency_ms(run.done), 90) if run.done else None
