"""Idle device milliseconds a traced request, credited to the program's
`pose.crops` and `pose.net` spans (innermost span open at each gap's midpoint)."""

from benchmark import program_spans as ps


def read(run):
    return ps.per_request(run, lambda p: p.idle_ms(ps.NET))
