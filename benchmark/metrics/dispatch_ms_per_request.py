"""Host milliseconds inside a request's dispatch span (its calls into the
per-chunk program, and any wait the program makes inside them), a traced request."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    return run.trace.span_seconds("bench.request") * 1e3 / len(run.traced)
