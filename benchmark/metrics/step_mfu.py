"""Percent of the card's dense bfloat16 peak that the traced window's valid
frames' matrix FLOPs (pose net, GCN, encoder, error head, counted from the
shapes by benchmark.counts) would fill over the window's length."""

from benchmark import counts
from benchmark.reference import nets


def read(run):
    if run.trace is None or not run.traced or run.peaks is None:
        return None
    stated = run.stated
    fd = nets.error_feature_dim(stated["error"])
    flops = sum(counts.request_flops(stated, d.lengths, run.ref_frames, fd) for d in run.traced)
    return 100.0 * flops / (run.peaks["bf16_flops"] * run.trace.window_s())
