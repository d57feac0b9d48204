"""Ops: plain torch functions and the wrappers of the hand-written CUDA kernels,
each counting its launches as `profiling.count("launch.<key>")`, a key of `KERNELS`."""

from golfaction_tpu_torch.utils import profiling

KERNELS = ("preprocess", "gcn_tail", "softdtw", "decode", "softdtw_bwd", "requant",
           "preprocess_bf16", "group_norm")


def launches_since(since: dict) -> dict:
    """{key: launches} of each kernel counted since `since`, an earlier
    `profiling.totals()`."""
    now = profiling.totals()
    return {k: now.get(f"launch.{k}", 0) - since.get(f"launch.{k}", 0) for k in KERNELS}
