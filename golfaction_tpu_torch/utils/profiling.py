"""Stage timing and device traces: the counterpart of the JAX package's
`golfaction_tpu/utils/profiling.py`.

`StageTimer` accumulates wall time per named stage, each stage annotated in
the profiler's trace (`torch.profiler.record_function`) and, when given a
CUDA fence, closed by a `torch.cuda.synchronize` of that device, so that a
stage's time includes the device work it enqueued.  `device_trace` records
a `torch.profiler` trace of the host and the card and writes it as a Chrome
trace.  `value_fence` and `timed_blocked` force completion by fetching a
value to the host, as the JAX ones do.

The JAX module's `enable_compile_cache` has no counterpart: the port has no
jit to cache, and its hand-written kernels are compiled once and kept in
`golfaction_tpu_torch/build/` by `ops/_kernels.py`, keyed on their sources.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Optional

import torch


def _cuda_device(fence: Any) -> Optional[torch.device]:
    """The CUDA device of `fence` (a tensor, or a device or its name), else None."""
    if isinstance(fence, torch.Tensor):
        fence = fence.device
    if isinstance(fence, (str, torch.device)):
        dev = torch.device(fence)
        return dev if dev.type == "cuda" else None
    return None


class StageTimer:
    """Accumulates per-stage wall times; emits a breakdown dict / JSON."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, fence: Any = None):
        """Time a stage under a profiler annotation of its name.

        `fence`: a CUDA tensor or device, synchronized before the timer
        stops; else the stage's time is the host's alone (the card runs
        asynchronously)."""
        dev = _cuda_device(fence)
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            if dev is not None:
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def breakdown(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": v, "count": self.counts[k], "mean_ms": 1e3 * v / self.counts[k]}
            for k, v in self.totals.items()
        }

    def report(self) -> str:
        return json.dumps(self.breakdown(), indent=2, sort_keys=True)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Record a torch.profiler trace (host, and the card where there is one)
    around a code region and write it to `log_dir` as a Chrome trace
    (chrome://tracing, Perfetto).  No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _first_tensor(out) -> torch.Tensor:
    if isinstance(out, dict):
        return _first_tensor(next(iter(out.values())))
    if isinstance(out, (list, tuple)):
        return _first_tensor(out[0])
    return out


def value_fence(out) -> float:
    """Force completion by fetching a scalar of `out` (a tensor, or the
    first tensor of a dict / list / tuple) to the host."""
    return float(_first_tensor(out).float().sum())


def timed_blocked(fn, *args, warmup: int = 1, iters: int = 5, **kw) -> float:
    """Mean wall seconds of fn(*args, **kw), completion forced by `value_fence`."""
    for _ in range(warmup):
        value_fence(fn(*args, **kw))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args, **kw)
    value_fence(out)
    return (time.perf_counter() - t0) / iters
