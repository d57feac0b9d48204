"""The traced window: torch.profiler's CUPTI trace of the card (device
activity only: recording every host operator too made the host's dispatch
2.3 times slower and the card look idle), reduced to what the per-layer
readers need.

The benchmark marks each span's edges itself: `Spans` launches a one-value
float64 fill on the card at each edge (the system fills no float64 tensor)
and notes the edge on the host.  In the trace, the fills' launches, in
order, give each edge its host time; every other device activity is tied
by its correlation id to the host launch that issued it, and the launch to
the innermost span open at that moment.  The device's busy time is the
union of the activities' intervals inside the window; an idle gap is put
down to the innermost span open at its midpoint.

CUPTI loses records at the edges of a profile: the device records of the
last launches before it stops, when it stops at once (up to 2,495 launches
on an H100), and, in a process that traced before, of the first launches
after it starts (up to 330).  `pad` puts a few thousand launches of its own
before the window and after it, and pauses before the profile stops, so
that what is lost lies outside the window; `Trace` then holds every kernel
launch inside the window to its device record, and raises `Lost` where one
has none, so that a window the profiler lost part of is never read.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARKER = "FillFunctor<double>"
KERNEL_LAUNCH = "LaunchKernel"          # cudaLaunchKernel[ExC], cuLaunchKernel[Ex]
LEAD, TAIL, TAIL_PAUSE_S = 2000, 3000, 0.5


class Lost(ValueError):
    """The profiler lost device records inside the window."""


def pad(device, launches: int, pause_s: float = 0.0) -> None:
    """Outside the window, under the profile: wait for the card, launch
    `launches` one-value int32 fills (not markers), wait for them, pause."""
    import torch

    torch.cuda.synchronize(device)
    cell = torch.zeros(1, dtype=torch.int32, device=device)
    for i in range(launches):
        cell.fill_(i)
    torch.cuda.synchronize(device)
    if pause_s:
        time.sleep(pause_s)


class Spans:
    """Span edges marked on the card.  `span(name)` is a context manager;
    with `on` False it does nothing."""

    def __init__(self, device=None, on: bool = False):
        self.on = on
        self.edges: list = []            # (name, +1 open | -1 close), in launch order
        if on:
            import torch
            self._cell = torch.zeros(1, dtype=torch.float64, device=device)

    def span(self, name: str):
        return self._span(name) if self.on else contextlib.nullcontext()

    @contextlib.contextmanager
    def _span(self, name: str):
        self._edge(name, 1)
        try:
            yield
        finally:
            self._edge(name, -1)

    def _edge(self, name: str, edge: int) -> None:
        self._cell.fill_(float(len(self.edges)))
        self.edges.append((name, edge))


class Span:
    __slots__ = ("name", "start", "end")

    def __init__(self, name, start, end):
        self.name, self.start, self.end = name, start, end


def innermost(spans: list, starts: list, t: float):
    """The innermost span containing t: spans are sorted by start and nest
    (one host thread opens them), so it is the latest-starting one."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if spans[i].end >= t:
            return spans[i]
        i -= 1
    return None


class Trace:
    """The window's activities: `ops` [(name, start_us, dur_us, span name)]
    (those launched inside the window, and those whose launch the trace
    lacks), `spans` [Span] (host, microseconds), `window` (start_us, end_us).
    Raises `Lost` where markers are missing or a kernel launch inside the
    window has no device record."""

    def __init__(self, events: list, edges: list, window: str = "bench.window"):
        launches, kernel_launches, device = {}, set(), []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = float(e["ts"])
                    if KERNEL_LAUNCH in str(e.get("name", "")):
                        kernel_launches.add(corr)
            elif cat in DEVICE_CATS:
                device.append(e)
        if not launches:
            raise ValueError("the trace holds no host launches (cuda_runtime events)")
        marks, ops = [], []
        for e in device:
            corr = (e.get("args") or {}).get("correlation")
            t = launches.get(corr)
            if MARKER in str(e.get("name", "")):
                marks.append((corr, t))
            else:
                ops.append((e, t))
        if len(marks) != len(edges) or any(t is None for _, t in marks):
            raise Lost(f"{len(marks)} span markers in the trace, {len(edges)} marked")
        marks.sort()                       # correlation ids follow the launch order
        spans, stack = [], []
        for (name, edge), (_, t) in zip(edges, marks):
            if edge > 0:
                stack.append((name, t))
            else:
                opened, t0 = stack.pop()
                if opened != name:
                    raise ValueError(f"span {name} closes {opened}")
                spans.append(Span(name, t0, t))
        spans.sort(key=lambda s: (s.start, -s.end))
        windows = [s for s in spans if s.name == window]
        if len(windows) != 1:
            raise ValueError(f"the trace holds {len(windows)} {window} spans, not 1")
        self.window = w0, w1 = (windows[0].start, windows[0].end)
        recorded = {(e.get("args") or {}).get("correlation") for e in device}
        lost = [c for c in kernel_launches if w0 < launches[c] < w1 and c not in recorded]
        if lost:
            raise Lost(f"{len(lost)} kernel launches inside the window have no device record")
        self.spans, self._starts = spans, [s.start for s in spans]
        self.ops = []
        for e, t in ops:
            if t is not None and not w0 <= t <= w1:
                continue                   # the padding
            span = innermost(spans, self._starts, t) if t is not None else None
            self.ops.append((str(e.get("name", "")), float(e["ts"]), float(e["dur"]),
                             span.name if span is not None else None))

    @classmethod
    def from_profiler(cls, prof, path: str, edges: list) -> "Trace":
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        return cls(data["traceEvents"] if isinstance(data, dict) else data, edges)

    def busy_intervals(self) -> list:
        """Union of the device activities' intervals, clipped to the window (us)."""
        w0, w1 = self.window
        iv = sorted((max(s, w0), min(s + d, w1)) for _, s, d, _ in self.ops
                    if s + d > w0 and s < w1)
        out = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def device_seconds(self, span: str = None, match=None) -> float:
        """Summed device time of the activities launched inside `span` (any
        span when None) whose name satisfies `match` (any when None)."""
        return sum(d for n, _, d, s in self.ops
                   if (span is None or s == span) and (match is None or match(n))) * 1e-6

    def span_seconds(self, name: str) -> float:
        """Host time inside spans called `name`."""
        return sum(s.end - s.start for s in self.spans if s.name == name) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        by = collections.Counter()
        for n, _, d, _ in self.ops:
            by[n[:96]] += d * 1e-6
        return [[n, s] for n, s in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device seconds inside the window by the host span open at each gap's midpoint."""
        w0, w1 = self.window
        edges = [w0]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(w1)
        by = collections.Counter()
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                s = innermost(self.spans, self._starts, (a + b) / 2)
                by[s.name if s is not None else "none"] += (b - a) * 1e-6
        return [[n, s] for n, s in by.most_common(top)]
