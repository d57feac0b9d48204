"""The ViT's attention: percent of the fused attention kernels' summed device
time inside the pose span that their least time would take.  The least time
is `vit_depth` attentions a valid frame of the traced requests, each the
larger of its least bytes at the card's memory rate and its FLOPs at the
dense bfloat16 peak (benchmark.reference.vitpose.attn_bytes_flops)."""

import re

from benchmark.reference import vitpose

# The fused scaled-dot-product kernels' names as an H100's trace gives them
# (torch 2.11, CUDA 12.8): cuDNN's, which the port takes there, flash's and
# the memory-efficient one's.
_PATTERN = re.compile(r"cudnn_generated_fort_native_sdpa|pytorch_flash::flash_fwd_kernel"
                      r"|fmha_cutlassF")


def is_attention(name: str) -> bool:
    """A device activity of a fused attention kernel."""
    return _PATTERN.search(name) is not None


def read(run):
    if run.trace is None or not run.traced or run.peaks is None:
        return None
    t = run.trace.device_seconds("bench.pose", is_attention)
    if t <= 0:
        return None
    p = run.stated["pose"]
    h, w = vitpose.token_grid(p)
    nbytes, flops = vitpose.attn_bytes_flops(1, h * w, p["vit_width"])
    per_frame = p["vit_depth"] * max(nbytes / run.peaks["hbm_bytes"],
                                     flops / run.peaks["bf16_flops"])
    return 100.0 * per_frame * sum(d.frames for d in run.traced) / t
