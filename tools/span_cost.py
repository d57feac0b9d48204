"""What one span of the port's recorder (`golfaction_tpu_torch/utils/profiling.py`)
costs the host: an empty `with span(...)` timed in a loop with the profiler
off (one check of its state), and on under a profile of the card alone (as
the benchmark's traced window opens it), or of the host where there is no
card.

    python tools/span_cost.py [--n 200000]

Prints one JSON line: off_pair_ns and on_pair_ns (nanoseconds for an open
and a close), the profile's activities, the device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pair_ns(span, n: int) -> float:
    t = time.perf_counter_ns()
    for _ in range(n):
        with span("x"):
            pass
    return (time.perf_counter_ns() - t) / n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=200000)
    args = p.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from golfaction_tpu_torch.utils import profiling

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    off = pair_ns(profiling.span, args.n)
    with profile(activities=activities):
        on = pair_ns(profiling.span, max(1, args.n // 10))
    profiling.reset()
    print(json.dumps({"off_pair_ns": off, "on_pair_ns": on,
                      "activities": [a.name for a in activities],
                      "device": torch.cuda.get_device_name(0) if cuda else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
