"""Idle device milliseconds a traced request, credited to the program's
`pose.decode`, `pose.track` and `pose.modes` spans and the host syncs inside them."""

from benchmark import program_spans as ps


def read(run):
    return ps.per_request(run, lambda p: p.idle_ms(ps.DECODE))
