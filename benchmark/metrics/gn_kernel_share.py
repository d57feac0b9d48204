"""Share of the pose net's GroupNorms that the traced requests computed in
kernel G: the program's `gn_kernel` counter (GroupNorms each launch of G
computed) over it plus `gn_plain` (GroupNorms computed in torch ops on a
card tensor), in percent."""

from benchmark import program_spans as ps


def read(run):
    p = ps.program(run)
    if p is None:
        return None
    kernel, plain = p.counts.get("gn_kernel", 0), p.counts.get("gn_plain", 0)
    if kernel + plain == 0:
        return None
    return 100.0 * kernel / (kernel + plain)
