"""Percent of the card's dense bfloat16 peak that the pose net's matrix FLOPs
(its reference module's `pose_flops` over the traced requests' valid
frames) would fill in the device time of the work launched inside the pose
span.  Padded frames and the crops, decode and head count in the time and
not in the FLOPs, so it cannot pass 100."""

from benchmark.reference import pose_reference


def read(run):
    if run.trace is None or not run.traced or run.peaks is None:
        return None
    t = run.trace.device_seconds("bench.pose")
    if t <= 0:
        return None
    frames = sum(d.frames for d in run.traced)
    flops = pose_reference(run.stated).pose_flops(run.stated["pose"]) * frames
    return 100.0 * flops / (run.peaks["bf16_flops"] * t)
