"""Host milliseconds a traced request waits in the program's `sync` spans
(host reads of a device value)."""

from benchmark import program_spans as ps


def read(run):
    return ps.per_request(run, lambda p: p.sync_ms())
