"""Device milliseconds of the work launched inside the pose span, a valid frame."""


def read(run):
    if run.trace is None:
        return None
    s = run.trace.device_seconds("bench.pose")
    frames = sum(d.frames for d in run.traced)
    return s * 1e3 / frames if s > 0 and frames else None
