"""Spans, counters, stage timing and device traces: the counterpart of the
JAX package's `golfaction_tpu/utils/profiling.py`.

`span(name)` and `count(name, n)` are the program's own instrumentation,
kept in memory (`recorded()`, `reset()`) while a `torch.profiler` profile is
active in the calling thread; a span otherwise costs one check of the
profiler's state.  Every count also goes to a running total, always on,
that `totals()` copies; readers diff two copies.  `tally()` collects a
block's counts instead, so that a replayed CUDA graph can count again what
its capture counted.  A recorded span is also a `record_function` range,
so a trace of host activity shows it.
`StageTimer` accumulates wall time per named stage, each stage a span and,
when given a CUDA fence, closed by a `torch.cuda.synchronize` of that
device, so that a stage's time includes the device work it enqueued.
`device_trace` records a `torch.profiler` trace of the host and the card
and writes it as a Chrome trace.  `value_fence` and `timed_blocked` force
completion by fetching a value to the host, as the JAX ones do.

The JAX module's `enable_compile_cache` has no counterpart: the port has no
jit to cache, and its hand-written kernels are compiled once and kept in
`golfaction_tpu_torch/build/` by `ops/_kernels.py`, keyed on their sources.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Any, Optional

import torch

# True while a torch.profiler profile (any activities, CUDA alone too) is
# active in the calling thread.
_profiling = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One closed span: `perf_counter_ns` stamps, its own id, the id of the
    span it opened in (None at the top level) and of its top-level span,
    which identifies the request."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    top: int


@dataclasses.dataclass(frozen=True)
class CountRecord:
    """One counter increment, with the innermost and the top-level span open
    where it was counted (None outside any span)."""

    name: str
    n: int
    span: Optional[int]
    top: Optional[int]


@dataclasses.dataclass(frozen=True)
class Recorded:
    """A snapshot: spans in the order they closed, counts in the order they
    were made, and how many records the full buffer turned away."""

    spans: tuple
    counts: tuple
    dropped: int


class Recorder:
    """Spans and counters kept in a bounded buffer while the profiler is on,
    and running totals of the counters.  Nesting is per thread; ids are
    unique across threads."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self._local = threading.local()
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._totals: dict = {}
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._spans, self._counts, self._dropped = [], [], 0

    def totals(self) -> dict:
        """A copy of the running totals, {name: n}, of the counts made
        outside a tally since the process began; `reset` leaves them."""
        with self._lock:
            return dict(self._totals)

    def recorded(self) -> Recorded:
        with self._lock:
            return Recorded(tuple(self._spans), tuple(self._counts), self._dropped)

    def span(self, name: str):
        """A context manager: a recorded span while the profiler is on, else
        a shared no-op."""
        return self._open(name) if _profiling() else _OFF

    def count(self, name: str, n: int = 1) -> None:
        """Count `n` of `name` into the totals, and here while the profiler
        is on; inside a `tally` of this thread, into the tally instead."""
        tally = getattr(self._local, "tally", None)
        if tally is not None:
            tally[name] = tally.get(name, 0) + n
            return
        with self._lock:
            self._totals[name] = self._totals.get(name, 0) + n
        if _profiling():
            stack = self._stack()
            self._keep(self._counts, CountRecord(name, n, stack[-1] if stack else None,
                                                 stack[0] if stack else None))

    @contextlib.contextmanager
    def tally(self):
        """A block whose counts in this thread go to the dict it yields
        ({name: n}), whatever the profiler's state, and neither to the
        totals nor to the records: what a call counted, for a replay of that
        call to count again."""
        outer = getattr(self._local, "tally", None)
        self._local.tally = counts = {}
        try:
            yield counts
        finally:
            self._local.tally = outer

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, into: list, record) -> None:
        with self._lock:
            if len(self._spans) + len(self._counts) < self.capacity:
                into.append(record)
            else:
                self._dropped += 1

    @contextlib.contextmanager
    def _open(self, name: str):
        stack = self._stack()
        sid = next(self._ids)
        parent = stack[-1] if stack else None
        top = stack[0] if stack else sid
        stack.append(sid)
        with torch.profiler.record_function(name):
            t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                t1 = time.perf_counter_ns()
                stack.pop()
                self._keep(self._spans, SpanRecord(name, t0, t1, sid, parent, top))


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
tally = RECORDER.tally
totals = RECORDER.totals
recorded = RECORDER.recorded
reset = RECORDER.reset


def host_sync():
    """A span around a point where the host waits for the card, counted in
    `host_syncs`: a read of a device value, or a copy from pageable host
    memory (`torch.tensor(..., device=card)`), which synchronizes the stream."""
    if not _profiling():
        return _OFF
    count("host_syncs")
    return RECORDER._open("sync")


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
        """Time a stage inside a span of its name.

        `fence`: a CUDA tensor or device, synchronized before the timer
        stops; else the stage's time is the host's alone (the card runs
        asynchronously)."""
        dev = _cuda_device(fence)
        with span(name):
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
    (chrome://tracing, Perfetto).  No-op when log_dir is None.

    Around `Pipeline.analyze_batch` (or any call into the per-chunk
    program) the trace shows the program's spans (`pose`, `pose.net`,
    `pose.vit.blocks` with the ViT backbone, `align.path`, `sync`, ...) as
    host ranges over the kernels they launched; `recorded()` holds the same
    spans and the counters (`host_syncs`, `gn_kernel`, `gn_plain`,
    `attn_fused`, `attn_plain`, `pose_graph`, `pose_eager`)."""
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
