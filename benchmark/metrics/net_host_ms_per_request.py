"""Host milliseconds a traced request spends in the pose net's own dispatch:
self time of the program's `pose.crops` (kernel A) and `pose.net` spans."""

from benchmark import program_spans as ps


def read(run):
    return ps.per_request(run, lambda p: p.host_ms(ps.NET))
