"""Host milliseconds a traced request spends in the compare: self time of the
program's `align` span and its children, less its `sync` spans."""

from benchmark import program_spans as ps


def read(run):
    return ps.per_request(run, lambda p: p.host_ms(ps.COMPARE))
