"""Idle device milliseconds a traced request, credited to the program's
`align` span and its children, `sync` spans included."""

from benchmark import program_spans as ps


def read(run):
    return ps.per_request(run, lambda p: p.idle_ms(ps.COMPARE))
