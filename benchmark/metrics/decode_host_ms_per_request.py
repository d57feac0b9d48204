"""Host milliseconds a traced request spends in the decode and tracking: self
time of the program's `pose.decode`, `pose.track` and `pose.modes` spans."""

from benchmark import program_spans as ps


def read(run):
    return ps.per_request(run, lambda p: p.host_ms(ps.DECODE))
