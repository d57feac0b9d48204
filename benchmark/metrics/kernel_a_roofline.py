"""Kernel A (csrc/preprocess.cu, crop/resize/normalize): percent of its
summed device time that its least time, by benchmark.counts.kernel_a_bytes_ops
over the traced requests' frames, would take."""

import re

from benchmark import counts

NAMES = ("crop_resize_normalize_kernel", "crop_resize_normalize_bf16_kernel")


_PATTERN = re.compile(r"\b(?:" + "|".join(NAMES) + r")\b")


def is_a(name: str) -> bool:
    """A device activity of this kernel (its demangled name, any namespace or template)."""
    return _PATTERN.search(name) is not None


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_seconds("bench.pose", is_a)
    if t <= 0:
        return None
    p = run.stated["pose"]
    bf16 = run.stated["preprocess_dtype"] == "bfloat16"
    least = 0.0
    for d in run.traced:
        cs, (H, W) = run.crop_boxes(d.item), run.image_hw
        nbytes, ops = counts.kernel_a_bytes_ops(cs, H, W, *p["input_hw"],
                                                out_bytes=2 if bf16 else 4,
                                                ops_per_px=60 if bf16 else 47)
        least += max(nbytes / run.peaks["hbm_bytes"], ops / run.peaks["fp32_flops"])
    return 100.0 * least / t
