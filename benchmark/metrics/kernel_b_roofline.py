"""Kernel B (csrc/gcn_tail.cu, the GCN block tail, its four kernels summed):
percent of their summed device time that the least time of the traced
requests' block tails, by benchmark.counts.kernel_b_bytes_ops, would take."""

import re

from benchmark import counts

NAMES = ("tail_rows_kernel", "tail_taps_kernel", "tail_gates_kernel", "tail_apply_kernel")


_PATTERN = re.compile(r"\b(?:" + "|".join(NAMES) + r")\b")


def is_b(name: str) -> bool:
    """A device activity of this kernel (its demangled name, any namespace or template)."""
    return _PATTERN.search(name) is not None


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_seconds("bench.heads", is_b)
    if t <= 0:
        return None
    g = run.stated["gcn"]
    least = 0.0
    for d in run.traced:
        N, T = run.request_shape(d.item)
        for C, w in zip(g["block_channels"], run.tail_weights):
            nbytes, ops = counts.kernel_b_bytes_ops(N, T, g["num_joints"], C, w)
            least += max(nbytes / run.peaks["hbm_bytes"], ops / run.peaks["fp32_flops"])
    return 100.0 * least / t
