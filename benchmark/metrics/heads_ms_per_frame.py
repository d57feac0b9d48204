"""Device milliseconds of the work launched inside the heads span (GCN and error head), a valid frame."""


def read(run):
    if run.trace is None:
        return None
    s = run.trace.device_seconds("bench.heads")
    frames = sum(d.frames for d in run.traced)
    return s * 1e3 / frames if s > 0 and frames else None
