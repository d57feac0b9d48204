"""Host reads of a device value a traced request makes: the program's
`host_syncs` counter."""

from benchmark import program_spans as ps


def read(run):
    return ps.per_request(run, lambda p: p.counts.get("host_syncs", 0))
