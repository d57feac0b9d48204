"""Device milliseconds of the work launched inside the compare span, a request."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    s = run.trace.device_seconds("bench.align")
    return s * 1e3 / len(run.traced) if s > 0 else None
